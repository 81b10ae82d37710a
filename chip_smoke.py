#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py            (from the repository root)

Phases, each of which must pass for the exit code to be 0:

  1. build   — compile the eight hand-written kernels (four sources in
               src/repro_torch/csrc) with nvcc for sm_90a, one nvcc per
               source, in parallel;
  2. kernels — hold each kernel and each of its variants against its plain
               PyTorch version on the card, at the main path's largest leaf
               (234,881,024 elements) and at a ragged size (1,000,003):
               integer kernels bit-equal, the fused updates bit-equal too
               (built with --fmad=false and IEEE sqrt/division; tolerance
               0) — packed SGD with shift, packed AdamW with and without
               shift, dense SGD and AdamW on int8/int16/int32 lanes with and
               without shift; the bf16 variants (a bf16 gradient into the
               encode, a bf16 param through the packed8 and int8-lane
               fused updates, with and without shift; at the ragged size
               also with NaNs in the param, compared as NaN) the same way.
               The encode runs as the main path calls it, raising an amax
               scalar to its image's |max|, which must equal the plain
               version's (also on an unclipped 32-bit image whose one
               planted peak lies in the grid-stride loop's last round), and
               is timed with and without amax in turns. Checks the wrap-around psum law with saturated
               fields (packed) and the lane-type sum at its extremes
               (dense), and times each kernel variant (median per launch
               over batches of 20 launches, CUDA events) and its plain
               version (median of single runs). block_norms (one launch;
               float32 and int32, nblocks 1 and 4, at the largest leaf, at
               1,000,003, at a size whose last chunk is empty, at one
               element, and at 65,535 blocks) is held to its plain version
               and to a float64 sum at rtol 1e-5 (the three sum in
               different orders); a second launch, a misaligned view x[1:]
               of the largest leaf, and all cases relaunched interleaved
               must agree bit for bit (the ticket counters return to 0).
               At the largest leaf it is timed in turns with torch.dot(x, x)
               (the library call) and torch.sum(x) (a read-rate probe), and
               at every granite-8b leaf size from a CUDA graph, summed per
               compressed step;
  3. train   — the headline path through the user entry point
               (launch.train.train_loop): granite-8b at full width, depth
               cut to 4 layers, 4 data-parallel workers simulated on the
               card, per-worker batch 1, seq 2048, packed8 wire, IntSGD,
               fused AdamW (wd 1e-4, lr 3e-4 with 5-step warmup), clip 1.0,
               4 steps (step 0 exact);
  4. train-sgd — slice 1's path, the same at 4 layers with fused
               momentum SGD (lr 0.3);
  5. family  — the six other corners of {SGD, AdamW} × {IntSGD, IntDIANA}
               × {packed8, dense8} at full width, depth 2, 4 workers,
               3 steps each;
  6. train-block — IntSGD with blockwise α (Alg. 2, one α per leaf) on
               the packed8 fused-SGD route, 4 layers, 4 steps: each leaf's
               α on the first compressed step is printed and must be
               finite, positive and not all equal; then the fused route
               with bf16 params (the JAX step's default), each printed
               beside its float32 counterpart: train-bf16 and
               train-sgd-bf16 (the headline and train-sgd corners, 4
               layers, 4 steps), family sgd/intsgd/dense8 bf16 and family
               adamw/intdiana/dense8 bf16 (2 layers, 3 steps);
  7. zero1   — the ZeRO-1 route (f32 master rows, the update in plain
               PyTorch, the JAX package's default): zero1-sgd (SGD /
               IntSGD / packed8, 4 layers, 4 steps), zero1-adamw-m2 (AdamW,
               2 pipelined microbatches, global batch 8, 4 layers, 4
               steps), zero1-intdiana-m2 (SGD / IntDIANA / dense8, 2
               microbatches, 2 layers, 3 steps), zero1-bf16 (zero1-sgd's
               corner with bf16 params, 4 layers, 4 steps);
  8. baseline-none — uncompressed SGD (`none`, a float mean) on the ZeRO-1
               route, 4 layers, 4 steps; zero1-heuristic (SGD / Heuristic
               IntSGD, Sapio et al.'s profiling max-reduce and fixed α /
               packed8, 4 layers, 4 steps); then the paper's baselines on
               the ZeRO-1 route at 2 layers, 3 steps: baseline-none-2l (the
               yardstick at their depth), zero1-qsgd (two int8 lanes),
               zero1-qsgd-packed8, zero1-natsgd, zero1-powersgd (rank 2),
               zero1-signsgd, zero1-topk (k_frac 0.01) and
               zero1-intsgd-topk8 (IntSGD on the sparse gather wire
               topk8:1048576, with its EF21 residual, metered by Logged).
               In phases 3-8 the launch counts are zeroed just before each
               path and read just after: every kernel's count (and counts
               of launches with an IntDIANA shift and of bf16 variants)
               must equal what that path implies, losses must be finite,
               max_int <= 4·lim and max_local_int <= lim (lim(8, 4·M) on a
               psum wire, 127 on topk8), and step 1's max_local_int must
               equal the largest |image| its encodes wrote (each image read
               back; at the leaves of at most 2^20 elements also held to the
               plain version's) — Heuristic IntSGD reports max_local_int 0,
               as the JAX package does, and its step-1 images are held
               within ±lim(8, 4) = ±31 instead; the float baselines encode
               nothing and report 0; zero1-intsgd-topk8's bytes metered at
               step 1 must equal wire_bytes (packed by 4 workers, gathered
               once). Each path's step times and peak memory are printed,
               zero1-heuristic's less zero1-sgd's and each 2-layer
               baseline's less baseline-none-2l's;
  9. cross-route — zero1-sgd's losses at steps 1-3 within 1e-2 relative of
               train-sgd's (same seed, weights, data and encode seeds), and
               baseline-none's step time beside zero1-sgd's and
               train-sgd's; train-sgd-bf16's losses beside zero1-bf16's
               (printed only: the fused route keeps no f32 master);
 10. wire    — step 1 of the headline path replayed for one leaf: the
               unpacked word sum equals the sum of the four workers' images;
 11. ranks   — four real ranks (``repro_torch.parallel.spawn``; the
               first body of the grid phases' one spawn, so it runs after
               phase 22) sharing the card through a gloo process
               group, each one worker of four corners at full width, seq
               2048, batch 1 per worker, 2 steps: ranks zero1-sgd (SGD /
               IntSGD / packed8, 1 layer: at 2 the script's phases had
               reached 872.7 s), ranks zero1-adamw-intdiana-m2
               (AdamW / IntDIANA / dense8, 2 pipelined microbatches whose
               reduces are issued async; 1 layer, as four ranks of it do not
               fit in 80 GB at 2), ranks fused-sgd-ring (fused SGD / IntSGD /
               packed8 on the bucketed wire, default bucket size; 1 layer,
               for the same reason), ranks
               zero1-intsgd-topk8 (SGD / IntSGD on topk8:1048576, the
               planes all-gathered by gloo; 1 layer). Each
               corner also runs on the local backend at n = 4 first. After
               every step the params' checksums must be equal on the four
               ranks, α and max_int identical; max_int <= 4·lim(8, 4·M);
               losses within 1e-2 relative of the local backend's; each
               rank's launch counts one worker's share. Prints each rank's
               peak memory, the sum of their reserved peaks against the
               card's free memory, and step times (four processes time-sharing one
               card, gloo staging the collectives through host memory: not
               a transport speed);
 12. nccl-1  — a one-rank NCCL process group in this process: int32 words
               and int8 lanes all-reduced over it come back as sent, and
               zero1-sgd's corner (2 layers, 3 steps) on it is held to the
               local backend at n = 1 (losses within 1e-2), both timed;
 13. simulator — core.simulate.SimTrainer on the card (the unfused
               aggregate path: the encode kernel and block_norms): the
               convergence milestone at the test sizes (IntSGD, Determ.
               and blockwise α reach the quadratic's optimum within 1e-5;
               IntSGD with momentum within 10 % of SGD's terminal logreg
               loss; the aggregate's variance does not grow with n;
               IntDIANA's max_local_int < 64 where IntGD's passes 1e4),
               then logreg at 12 workers x 4,096 rows, d = 300, 200 steps,
               within the 10 % band and timed; launch counts per run.
 14. baselines — each baseline's aggregate at half the largest 1-layer
               leaf (4096 x 7168 = 29,360,128 elements), four workers'
               gradients from a seed, on the card and on CPU copies with
               the same seeds and state: Heuristic IntSGD's ĝ, NatSGD's
               exponents, signs and ĝ, TopK's indices, ĝ and error feedback
               bit-equal; QSGD's levels bit-equal given the same norm and
               uniforms, its ĝ within one level step (the norm is a
               reduction: a level flips where u lies within an ULP of its
               fraction); SignSGD's signs bit-equal, its ĝ and PowerSGD's
               ĝ and error feedback within 1e-5 of the largest |value|
               (reductions in another order); TopKInt's encode (n_workers
               = 1), planes and unpacked 4-worker sum bit-equal; and an
               image of values in -3..3 whose top-2^20 selection must be
               the CPU's, ties to the lowest indices, on the card.
 15. dense family — the other dense configs at published width, 2 layers,
               4 workers, 4 steps, IntSGD on packed8, with every check of
               phases 3-8 (launch counts for their leaf counts, the clip,
               step 1's max_local_int against its encodes) and their peaks
               below 80 GB: qwen-fused-sgd (qwen2.5-32b, QKV bias, fused
               SGD, bf16 params), minitron-zero1-adamw (minitron-4b, the
               786,432,000-element embedding, ZeRO-1 AdamW),
               danube-window (h2o-danube-3-4b at seq 8192, past its 4,096
               window, ZeRO-1 SGD) and internvl2-vlm (internvl2-2b, 256
               patch embeddings + 1,792 text tokens through
               build_train_step and launch.inputs.materialize_batch,
               ZeRO-1 SGD); the window at full width (danube's attention at
               T = 8192, token 0 perturbed: positions >= 4096 unchanged
               within 1e-6, every earlier one changed, and without the
               window the late ones changed); the attention's backend pin
               timed in turns against PyTorch's own choice on granite-8b's
               zero1-sgd corner (2 layers), and internvl2's logits GEMM at
               its vocabulary and padded to a multiple of 8 (printed);
               each new config's forward
               loss at 1 layer, seq 128, on the card against the CPU
               within 1e-2; and int_compress, pack_words, unpack_words,
               fused_unpack_sgd and block_norms once more at the
               786,432,000-element leaf, against their plain versions and
               timed beside their bounds;
 16. checkpoint — internvl2-2b at 1 layer, ZeRO-1 SGD / IntSGD / packed8,
               bf16 params: saved at step 2 (checkpoint.CheckpointStore, a
               temporary directory under build/, removed after), restored
               bit-equal to what was saved, resumed to step 4 within 1e-2
               of a straight run's losses;
 17. moe family — the moe configs at published width, 4 workers, 4 steps,
               seq 2048, IntSGD on packed8, with every check of phases 3-8:
               mixtral-fused-sgd (mixtral-8x22b, 1 layer: 2,906,720,256
               params, the 805,306,368-element expert leaves; fused SGD,
               lr 0.3, bf16 params but the router, which stays float32 on
               the fused route, so expected_launches counts its encode and
               fused update as float32 variants) and deepseek-zero1-adamw
               (deepseek-v2-lite-16b, MLA and 64 + 2 shared experts, 2
               layers, ZeRO-1 AdamW, lr 3e-4, float32), their peaks below
               80 GB; for one full-width layer of each, the MoE block's
               bf16 input routed on the card and on the CPU (at least
               99.9 % of the (token, choice) ids agree; the dispatch slots
               and drop mask from the card's ids equal the CPU's from the
               same ids; tokens per expert and the dropped share printed);
               for mixtral's, each stage of the block timed forward and
               backward with CUDA events (routing, dispatch, expert GEMMs,
               combine; printed); each config's loss at 1 layer, seq 128,
               on the card against the CPU within 1e-2;
 18. hybrid family — zamba2-2.7b at published width, 18 layers (two
               blocks of attn_every 9: 999,699,680 params, the shared
               attention block applied twice), 4 workers, 4 steps, seq
               2048, IntSGD on packed8, with every check of phases 3-8:
               zamba2-fused-sgd (fused SGD, lr 0.3, bf16 params) and
               zamba2-zero1-adamw (ZeRO-1 AdamW, lr 3e-4, float32), their
               peaks below 80 GB; one Mamba2 layer at full width timed by
               stage forward and backward with CUDA events (input
               projections, conv, SSD intra, states and inter, gate and
               norm, out-projection), the layer as trained and the shared
               block with the host's enqueue time beside the device time
               (printed); the loss at 9 layers, seq 512 (two SSD chunks),
               float32, on the card against the CPU within 1e-3; and
               int_compress, pack_words, unpack_words, fused_unpack_sgd
               and block_norms at the 471,859,200-element layers/m/w_xz,
               against their plain versions and timed;
 19. xlstm family — xlstm-125m at published width, 6 of its 12
               layers (two (mLSTM, mLSTM, sLSTM) blocks: 55,189,280
               params in 24 leaves, the embedding tied to the head), 4
               workers, 4 steps, seq 2048, IntSGD on packed8, with every
               check of phases 3-8 (launch counts for its 24 leaves, from
               the 38,633,472-element embed to the 32-entry if_bias):
               xlstm-fused-sgd (fused SGD, lr 0.3, bf16 params) and
               xlstm-zero1-adamw (ZeRO-1 AdamW, lr 3e-4, float32), their
               peaks below 80 GB; one mLSTM and one sLSTM layer at full
               width timed by stage forward and backward with CUDA events
               (mLSTM: projections, intra, the chunk carry, inter, norm and
               out-projection; sLSTM: projection, the time loop, norm and
               out-projection), each layer as trained and the time loop
               alone with the host's enqueue time beside the device time,
               the loop's µs a time step and its share of each path's step
               (printed); the time loop (its backward written by hand) at
               full width against the same loop through autograd, hidden
               states and gradients within 1e-4 of their largest |value|,
               both timed in turns; the loss at 6 layers, seq 512 (two
               mLSTM chunks, 512 sLSTM steps), float32, on the card against
               the CPU within 1e-3.
 20. encdec family — seamless-m4t-medium at published width and full
               depth, 12 encoder and 12 decoder layers (877,445,120 params
               in 37 leaves, lm_head untied, the 262,354,944-element embed
               and lm_head the largest), 4 workers, 4 steps, seq 2048
               (2,048 audio frames of 160 and 2,048 target tokens a worker,
               through build_train_step and materialize_batch as VlmRun
               drives them), IntSGD on packed8, with every check of phases
               3-8 (launch counts for its 37 leaves: 444 encodes a path):
               seamless-fused-sgd (fused SGD, lr 0.3, bf16 params) and
               seamless-zero1-adamw (ZeRO-1 AdamW, lr 3e-4, float32), their
               peaks below 80 GB, their exact-step losses within 1e-2 of
               each other (later steps printed: the optimizers differ); the
               three logits GEMMs at the vocabulary of 256,206 against
               256,208, timed in turns (printed); one encoder and one
               decoder layer at full width timed by stage forward and
               backward with CUDA events (LayerNorm, QKV and RoPE,
               bidirectional and causal attention, out-projection, cross
               attention's K/V projection and its attention, the GELU MLP;
               the logits and the loss), each layer as trained with the
               host's enqueue time beside the device time (printed); the
               loss at 2 + 2 layers, seq 256, float32, on the card against
               the CPU within 1e-3, the encoder states within 1e-4 of their
               largest |h|.
 21. serve and runtime — the serve path and the runtime through their
               entry points: granite-8b at published width and full depth
               (36 layers, bf16 params, 8,254,689,280 of them) served by
               serving.ServeEngine (4 slots, max_seq 128) to 6 requests of
               4-7 prompt tokens and 16 new tokens (every request done,
               every token in the vocabulary, one prompt's continuation the
               same alone and beside a companion; iterations, ms a decode
               step, tokens/s, peak GiB and one step's host enqueue over
               its card time printed); the weight refresh over the integer
               wire on it (each leaf's Δ = 1e-3·N(0, 1) encoded at α = 1000
               on packed8 with int_compress and packed with pack_words, one
               leaf at a time; apply_wire_delta launching unpack_words once
               a leaf, its params bit-equal to the plain path applied to
               the same words, chunk by chunk; its wire bytes and time
               printed); at granite's width and 2 layers, float32: decoding
               a 32-token prompt gives lm_forward's logits within 1e-4 of
               the largest |logit|, 8 decode steps on the card give the
               CPU's logits and caches within 1e-5 of their largest |value|,
               and the refresh lands within 1/α + 1e-6 of Δ;
               deepseek-v2-lite-16b at published width and full depth (27
               layers, MLA's latent cache, 64 routed and 2 shared experts,
               bf16) serving 4 requests of 8 new tokens with no (token,
               expert) pair dropped (its latent cache's bytes a token beside
               a GQA cache's, and ms a decode step, printed), and at 2
               layers, float32, the first greedy token of 4 slots equal on
               the card and the CPU; the straggler-tolerant sum
               (runtime.straggler) of four workers' images of granite's 12
               leaves at 4 layers (int_compress at the packed8 clip for n =
               4), worker 2 late: packed8 and dense8 bit-equal, equal to the
               int64 sum of the three alive images, unchanged when the dead
               worker's image is in-range garbage, n_live 3, decode_partial
               bit-equal to its plain expression, an all-dead round flagged
               and finite, 48 pack_words and 12 unpack_words launches; and
               the elastic re-plan and resume (runtime.elastic,
               train_loop(resume=True)): granite's width at 2 layers, fused
               SGD / IntSGD / packed8, float32, 4 workers for 4 steps with a
               checkpoint at step 4 (a temporary directory under build/,
               removed after), plan_after_failures(dp=4, failed [3]) giving
               3 workers and clip limit 31->42, then 4 steps at 3 workers
               from the checkpoint: losses finite, max_int <= 3·42, within
               1e-2 of a fresh 3-worker loop from the restored state, every
               run's launch counts exact.
 22. recurrent and encoder-decoder decode — zamba2-2.7b at published
               width and full depth (54 Mamba2 layers, 6 applications of the
               shared block, bf16 params) served by ServeEngine with phase
               21's traffic (every request done, every token in the
               vocabulary), then refreshed over packed8 as phase 21 does
               (int_compress and pack_words once a leaf, unpack_words once a
               leaf in apply_wire_delta; the largest leaf bit-equal to the
               plain path); xlstm-125m at full depth (12 layers) served the
               same way; seamless-m4t-medium at full depth (12 + 12 layers,
               bf16): encdec_prefill of 4 sequences of 2,048 frames and 16
               greedy encdec_decode_step tokens (finite logits, tokens in the
               vocabulary). Per family: ms a decode step (median, min), one
               step's host enqueue over its card time, iterations, tokens/s,
               peak GiB, the state's bytes a slot beside a GQA cache's at
               max_seq (seamless: the prefill's ms). At 2 layers (xlstm: one
               block of 3; zamba2 with attn_every 2, so that the shared block
               runs; seamless 2 + 2), float32: decoding a 32-token prompt
               gives lm_forward's (seamless: decode_states') logits within
               1e-4 of the largest |logit|, and 8 decode steps on the card
               give the CPU's logits and caches within 1e-5 of their largest
               |value|.
 23. tensor parallelism — four gloo ranks sharing the card on a 2 × 2
               data × model grid (launch.mesh.make_debug_mesh), each rank's
               shard at published width through train_loop (seamless:
               build_train_step and materialize_batch, as VlmRun drives
               them), 3 steps each at seq 2048, global batch 4, IntSGD /
               packed8: granite-8b at 2 layers, bf16 params, fused SGD;
               deepseek-v2-lite-16b at 1 layer (moe_ep: 32 experts a rank,
               the dispatch exchanged by all-to-all; MLA on 8 heads a rank),
               float32, ZeRO-1 AdamW; zamba2-2.7b at 9 layers (one block:
               40 of 80 SSM heads, 16 of 32 shared-attention heads a rank),
               bf16, fused SGD; xlstm-125m at 3 layers (one (m, m, s) block,
               2 of 4 heads, the tied embedding's 25,152 of 50,304 rows a
               rank), float32, ZeRO-1 AdamW; seamless-m4t-medium at 2 + 2
               layers (2,048 frames and tokens a sequence, 8 of 16 heads,
               128,103 of 256,206 vocabulary rows a rank), bf16, fused SGD.
               Checks: losses finite; max_int <= 2·63; the two dp replicas
               of each model shard bit-identical after every step (params'
               checksums); every rank's kernel launches exact for its local
               leaves; deepseek's MoE dropped share of (token, choice) pairs
               under 30 %; the step-0 loss within 1e-2 relative of the same
               global params at tp = 1 on the local backend (n = 2, on the
               card) for granite, deepseek and seamless, and printed for
               zamba2 and xlstm, which compute another function at tp = 2
               (the reference's contiguous split of Mamba2's w_xz and the
               mLSTM's w_if and if_bias, and its gated norms over the local
               shard); instead, in the same spawn, zamba2's (bf16, fused
               SGD) and xlstm's (float32, ZeRO-1 AdamW) smoke configs run
               build_train_step's exact step on the grid on the card and on
               the CPU from the same params, batch and seeds: losses within
               1e-2 (bf16) and 1e-3 (float32). Prints each rank's ms a step
               and peak GiB (granite's and deepseek's with phase 24's
               checkpoint saved), the all-to-all's ms and the psum_tp calls
               a step.
 24. checkpoints and TP serving on the grid — four gloo ranks on the 2 × 2
               grid again (one spawn). Checkpoints in the JAX package's
               global layout (CheckpointStore(grid=, specs=)), with
               PyTorch's deterministic algorithms on: phase 23's granite-8b
               (2 layers, bf16, fused SGD packed8) and deepseek-v2-lite-16b
               (1 layer, float32, ZeRO-1 AdamW packed8) runs at seq 2048 are
               the uninterrupted 3-step train_loops, deterministic, that
               save after their second step; a fresh grid (new process
               groups) resumes each for the third: that step's loss and
               every rank's params' checksums equal the uninterrupted
               run's, both runs' kernel launches exact; s to host, to disk and to restore and the
               bytes printed. Then the elastic resume 2 × 2 -> 1 × 2 of
               granite's checkpoint (rank 3 lost: runtime.elastic's plan,
               make_debug_mesh over the two survivors): finite, equal
               losses. TP decode through launch.step.build_serve_step's
               prefill (the rank's vocab-local logits, finite)
               and decode at published width, bf16: granite-8b at 12 layers (its 36 cut
               for time) and deepseek-v2-lite-16b at 4 layers (MLA on 8 of 16 heads,
               moe_ep at decode) with the serve CLI's traffic (4 sequences,
               2 a data replica, max_seq 128, prompts of 4–7 tokens fed
               token by token, then 16 greedy tokens); granite at 4 layers
               sequence-sharded (global batch 1, max_seq 64 split 32 a
               data replica, 48 tokens, so both shards are written). Each
               against the tp = 1 decode of the same global params in this
               process (every rank's shard its slice, by checksums): the
               step-0 logits on the served bf16 cache with float32
               activations within 2e-2 of the largest |logit| (bf16's
               printed); tp = 1's token stream decoded again on the grid
               and at tp = 1 with float32 activations and cache, every
               rank's vocab-local logits at every step within 1e-4 of the
               row's largest |logit| (the sequence-sharded run's steps 32+
               on the second data replica's slots printed apart); the two
               TP members' tokens equal, each sequence's greedy tokens
               equal to tp = 1's up to its first step whose tp = 1 top-2
               gap is under 2e-2 of the largest |logit|. Prints ms a decode step a rank, one step's
               host over card time, the model and data groups' calls a
               step and the peak GiB a rank.
 25. TP serving of the hybrid, ssm and encoder-decoder families — four
               gloo ranks on the 2 × 2 grid (one spawn), phase 24's traffic,
               bf16, random weights drawn a layer at a time, each through
               build_serve_step's prefill (vocab-local logits finite) and
               decode: zamba2-2.7b at 18 layers (two blocks of 9: 40 of 80
               SSM heads and 16 of 32 shared-attention heads a rank, the
               shared block's KV used twice), xlstm-125m at its 12 (2 of 4
               heads a rank), seamless-m4t-medium at its 12 + 12 on 2,048
               frames a sequence (encdec_prefill of each rank's rows, 8 of
               16 heads); zamba2 at 9 layers and seamless at 2 + 2 (256
               frames) sequence-sharded (batch 1, max_seq 64 split 32 a
               data replica, 48 tokens; each shard's first attention cache
               holds exactly its own positions). seamless against its tp = 1
               decode as phase 24 holds granite; zamba2 and xlstm, which
               compute another function at tp = 2: shards by checksums, TP
               members' tokens equal, step-0 and float32 logits finite, the
               gaps to tp = 1 printed; their smoke grids' float32 decode on
               the card within 1e-4 of the CPU's largest |logit|. The decode
               paths launch no kernel of ours. Prints ms a decode step a
               rank, host over card, the groups' calls a step, the prefill's
               ms and the peak GiB a rank.
 26. the paper's other compressors at tp = 2 — xlstm-125m at published
               width, 6 layers (two (m, m, s) blocks: every stacked leaf has
               PowerSGD's rank of 2 rows), seq 512, global batch 4, float32
               params, ZeRO-1 SGD (0.9), lr 0.3 with the 5-step warmup, clip
               1.0, 3 steps through train_loop on the grid: none,
               allgather_sgd, qsgd, qsgd on packed8, natsgd, powersgd,
               signsgd, topk and IntSGD on topk8:1048576. PowerSGD at its
               default min_compress_size refuses to build there (the sLSTM
               bias layers/s/cell/b, 6,144 elements globally, 3,072 a
               shard: the reference fails to build too), checked, and runs
               at min_compress_size 3,072. Checks: losses finite, the
               paths' step-0 losses within 1e-5 relative (the exact step),
               the data replicas of each shard and the replicated leaves
               across the model group bit-identical after every step (by
               checksums), the kernels' launches exact; the smoke config at
               6 layers on the same grid, 3 steps of powersgd and of qsgd
               on the card and on the CPU from the same params, batches and
               seeds (counter-PRNG uniforms, the same on both): losses
               within 1e-3. Prints ms a step a rank, peak GiB a rank and
               the data group's calls a step.
 27. pipeline parallelism — granite-8b's decoder layer at published width
               (d 4096, 32 heads, GQA 8, d_ff 14336), 8 layers, float32, 2
               a stage on the flat group of four ranks as the stage group,
               6 microbatches of (1, 512) tokens' hidden states through
               ``parallel.pp.pipeline_forward`` with the port's
               ``transformer._layer``, then the backward of Σ out² on every
               rank. The parent computes the sequential 8-layer stack per
               microbatch and its gradients on the card first (the same
               seeded layers), frees the card and leaves them in files the
               ranks read. Checks: the last stage's output within rtol 1e-4
               and atol 1e-5 (the reference test's), every stage's
               parameter gradients and stage 0's input gradient within
               1e-4 of the leaf's largest |gradient| (float32 sums in
               another order: the SDPA backward's atomics), stages 0-2's
               outputs zeros, one ring send a tick each way. Prints ms of
               the forward and of the backward, the bubble fraction, the
               ring bytes a tick and the peak GiB a rank. Four processes
               share one card through gloo: not a transport speed.

The dry run (``python -m repro_torch.launch.dryrun --all``: every runnable
cell's per-rank argument bytes on the data 16 × model 16 layout, on meta
tensors) runs once after phase 22, in this process (no card touched); every
cell must give a line without an error.

Phases 11 and 23-27 run in one spawn of four gloo ranks, after the dry run:
the parent computes every reference first (phase 11's local backend,
phase 23's step-0 losses at tp = 1, phases 24-25's float32 streams and
frames, phase 26's refusal, phase 27's sequential stack), each rank runs
the six phase bodies in turn (phase 11's corners on the flat group of
four, then the grid phases on the 2 × 2 grid, then phase 27 on the flat
group), freeing its memory between them, and the parent checks each
phase's results; it prints each phase's seconds inside the ranks (the
max over ranks), the spawn's start-up (spawn to each rank's first line)
and the card's free memory before the spawn.

Prints one JSON line of per-kernel numbers (each variant timed at the
largest leaf, and the launches of the bf16 variants), then the card's name and power
limit (nvidia-smi), then {"ok": true, "device": {...}} as the last line.
Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LARGEST_LEAF = 4 * 4096 * 14336  # layers/mlp/w_* at 4 layers
RAGGED = 1_000_003
N_WORKERS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "int_compress": "src/repro/kernels/int_compress.py:66",
    "pack_words": "src/repro/kernels/wire_pack.py:43",
    "unpack_words": "src/repro/kernels/wire_pack.py:68",
    "fused_unpack_sgd": "src/repro/kernels/fused_update.py:219",
    "fused_unpack_adamw": "src/repro/kernels/fused_update.py:219",
    "fused_apply_sgd": "src/repro/kernels/fused_update.py:176",
    "fused_apply_adamw": "src/repro/kernels/fused_update.py:176",
    "block_norms": "src/repro/kernels/block_norms.py:30",
}
# float/integer operations per image element, counted from each kernel's
# arithmetic (for the compute side of the bound)
OPS_PER_ELEMENT = {
    "int_compress": 20, "pack_words": 3, "unpack_words": 3, "fused_unpack_sgd": 8,
    "fused_unpack_adamw": 20, "fused_apply_sgd": 8, "fused_apply_adamw": 18,
    "block_norms": 2,
}
# the variant of each kernel the headline numbers use: the main path's
# (packed8, no shift) or, for the dense kernels, int8 lanes without shift
MAIN_VARIANT = {
    "int_compress": "stochastic", "pack_words": "packed8", "unpack_words": "packed8",
    "fused_unpack_sgd": "packed8", "fused_unpack_adamw": "packed8",
    "fused_apply_sgd": "int8", "fused_apply_adamw": "int8",
    "block_norms": "float32",
}
STATE_BYTES = {"sgd": 8, "adamw": 16}  # f32 optimizer state, read and written


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bytes_moved(name: str, d: int, lane_bytes: float, shift: bool = False,
                float_bytes: int = 4) -> int:
    """Bytes the function must move: each input read once, each output
    written once. ``lane_bytes`` is the integer payload per element (4/k
    for packed words, 1, 2 or 4 for dense lanes); ``float_bytes`` that of
    the encode's input or the fused update's param (2 for bf16)."""
    payload = int(round(lane_bytes * d))
    fixed = {
        "int_compress": (float_bytes + 4) * d,
        "pack_words": 4 * d + payload,
        "unpack_words": payload + 4 * d,
    }
    if name in fixed:
        return fixed[name]
    kernel = name.rsplit("_", 1)[1]
    return (payload + STATE_BYTES[kernel] * d + 2 * float_bytes * d
            + (8 * d if shift else 0))


def bound(name: str, nbytes: int, d: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[name] * d / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def batch_ms(torch, fn, batch: int) -> float:
    """Device time per run of ``fn``: CUDA events around ``batch`` runs."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(batch):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / batch


def interleaved_ms(torch, fns, rounds: int = 12, batch: int = 20) -> list:
    """Median time per run of each function, timed in turns within one call
    (f1, f2, ..., f2, f1 in every round, each a batch of ``batch`` runs):
    the way to tell two versions apart by 1 %."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(rounds):
        for i in order + order[::-1]:
            times[i].append(batch_ms(torch, fns[i], batch))
    return [statistics.median(t) for t in times]


def graph_ms(torch, fn, batch: int = 20, reps: int = 7) -> float:
    """Median device time per run of ``fn`` replayed from a CUDA graph of
    ``batch`` runs, so that the host's launch cost does not count (it
    would, at the small leaves, with launches issued one by one)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        times.append(batch_ms(torch, graph.replay, 1) / batch)
    del graph
    return statistics.median(times)


class Checks:
    """Records every comparison; the run fails at the end if any failed."""

    def __init__(self):
        self.failed = []

    def equal(self, what: str, got, want) -> float:
        """Bit for bit; a NaN is compared as NaN (at the same places in
        both), not by its bit pattern."""
        nan = got.isnan() if got.is_floating_point() else None
        same_nan = nan is None or (got.shape == want.shape and bool((nan == want.isnan()).all()))
        if nan is not None and same_nan:
            got, want = got[~nan], want[~nan]
        err = (got.to(want.dtype) - want).abs().max().item() if got.numel() else 0.0
        ok = got.shape == want.shape and got.dtype == want.dtype and err == 0 and same_nan
        nans = "" if nan is None or not bool(nan.any()) else f", {int(nan.sum())} NaN alike"
        print(f"  [{'ok' if ok else 'MISMATCH'}] {what}: max_abs_err {err}{nans}", flush=True)
        if not ok:
            self.failed.append(what)
        return float(err)

    def close(self, what: str, got, want, rtol: float) -> float:
        """|got - want| <= rtol·|want| elementwise; the largest absolute
        error."""
        g, w = got.double(), want.double()
        err = (g - w).abs().max().item() if got.numel() else 0.0
        rel = ((g - w).abs() / w.abs().clamp(min=1e-300)).max().item() if got.numel() else 0.0
        ok = got.shape == want.shape and bool(((g - w).abs() <= rtol * w.abs()).all())
        print(f"  [{'ok' if ok else 'MISMATCH'}] {what}: max_abs_err {err}, "
              f"max_rel_err {rel:.3g} (rtol {rtol})", flush=True)
        if not ok:
            self.failed.append(what)
        return float(err)

    def true(self, what: str, cond: bool) -> None:
        print(f"  [{'ok' if cond else 'FAILED'}] {what}", flush=True)
        if not cond:
            self.failed.append(what)


class Timings:
    """Each kernel variant's numbers: the largest error over every size and
    variant checked, and, at the largest leaf, both versions' times."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {}
        self.rows = []  # one per (kernel, variant) at the largest leaf

    def add(self, name, variant, d, nbytes, err, cuda_fn=None, plain_fn=None,
            plain_reps=3, ms=None, library_ms=None):
        """Every kernel's ``ms`` is the median per launch over batches of
        20 launches (:func:`interleaved_ms`), timed here from ``cuda_fn``
        or, with ``library_ms`` (the one PyTorch call that computes the
        same function, a yardstick only), by the caller in turns with it;
        the plain version's is the median of single runs."""
        self.err[name] = max(self.err.get(name, 0.0), err)
        if plain_fn is None:
            return
        if ms is None:
            ms = interleaved_ms(self.torch, [cuda_fn])[0]
        plain_ms = cuda_ms(self.torch, plain_fn, plain_reps)
        bound_ms, bound_by = bound(name, nbytes, d)
        self.rows.append(dict(name=name, variant=variant, d=d, bytes=nbytes, ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms))
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"  time {name} [{variant}]: {ms:.3f} ms (plain {plain_ms:.3f} ms{lib}, "
              f"bound {bound_ms:.3f} ms by {bound_by}, {nbytes} bytes)", flush=True)

    def main_row(self, name):
        for r in self.rows:
            if r["name"] == name and r["variant"] == MAIN_VARIANT[name]:
                return r
        raise KeyError(name)


def compare(checks, what, got, want, labels):
    """Every output of a kernel against its plain version; the largest
    error."""
    if len(got) != len(want) or len(got) != len(labels):
        checks.true(f"{what}: {len(got)} outputs, plain version {len(want)}", False)
        return float("inf")
    return max(checks.equal(f"{what} {lab}", g, w) for lab, g, w in zip(labels, got, want))


def fused_inputs(torch, gen, device, d, kernel, shift, param_dtype, nan):
    """p (with a NaN every 1000th element when ``nan``), optimizer state,
    scalar vector and shift at the main path's magnitudes."""
    p = (torch.randn(d, generator=gen, device=device) * 0.02).to(param_dtype)
    if nan:
        p[::1000] = float("nan")
    m = torch.randn(d, generator=gen, device=device) * 1e-3
    inv_nalpha = 1.0 / (N_WORKERS * 9000.0)
    if kernel == "sgd":
        state = (m,)
        sc = [inv_nalpha, 0.37, 0.3, 0.9, 1e-4]
    else:
        state = (m, torch.randn(d, generator=gen, device=device).abs() * 1e-5)
        t = 3  # [inv_nalpha, clip, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2]
        sc = [inv_nalpha, 0.37, 3e-4, 0.9, 1.0 - 0.9, 0.95, 1.0 - 0.95, 1e-8, 1e-4,
              1.0 - 0.9**t, 1.0 - 0.95**t]
    sc = torch.tensor(sc, dtype=torch.float32, device=device)
    h = torch.randn(d, generator=gen, device=device) * 0.01 if shift else None
    return p, state, sc, h


def fused_variants(torch, ops, checks, timings, gen, device, d, big, *, payload,
                   lane_bytes, tag, ops_and_kw, param_dtypes=("float32",)):
    """Each fused kernel variant on one summed payload against its plain
    version (and timed at the largest leaf); a bf16 param also with NaNs
    at the ragged size."""
    cases = [(dt, nan) for dt in param_dtypes
             for nan in ((False,) if big or dt == "float32" else (False, True))]
    for op, kw, shifts in ops_and_kw:
        kernel = op.name.rsplit("_", 1)[1]
        for shift, (dt, nan) in ((sh, c) for sh in shifts for c in cases):
            p, state, sc, h = fused_inputs(torch, gen, device, d, kernel, shift,
                                           getattr(torch, dt), nan)
            variant = (tag + ("+shift" if shift else "") + ("" if dt == "float32" else " bf16")
                       + (" NaN" if nan else ""))
            cuda = lambda: op.cuda(payload, p, *state, sc, shift=h, **kw)
            plain = lambda: op.plain(payload, p, *state, sc, shift=h, **kw)
            got, want = cuda(), plain()
            labels = ("param'", "mom'") if kernel == "sgd" else ("param'", "mu'", "nu'")
            err = compare(checks, f"{op.name} [{variant}]", got, want,
                          labels + (("shift'",) if shift else ()))
            del got, want
            nbytes = bytes_moved(op.name, d, lane_bytes, shift, p.element_size())
            if big:
                timings.add(op.name, variant, d, nbytes, err, cuda, plain, plain_reps=2)
            else:
                timings.add(op.name, variant, d, nbytes, err)
            del p, state, sc, h


def kernels_phase(torch, ops, checks, device):
    """Each kernel and variant against its plain version; returns the
    timings (the largest leaf) and largest errors."""
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.parallel.collectives import psum_wire_words
    from repro_torch.wire import DenseInt

    gen = torch.Generator(device=device).manual_seed(1234)
    timings = Timings(torch)
    for d in (LARGEST_LEAF, RAGGED):
        big = d == LARGEST_LEAF
        print(f"kernels at d = {d}", flush=True)
        # encode: gradient-like values, alpha on the card, both modes, a
        # float32 and a bf16 gradient
        x32 = torch.randn(d, generator=gen, device=device) * 3e-3
        alpha = torch.full((), 9000.0, device=device)
        seed = torch.full((), -123456789, dtype=torch.int32, device=device)
        for x, stochastic in ((x, st) for x in (x32, x32.to(torch.bfloat16))
                              for st in (True, False)):
            kw = dict(n_workers=N_WORKERS, bits=8, stochastic=stochastic)
            bf16 = x.dtype == torch.bfloat16
            variant = ("stochastic" if stochastic else "half-even") + (" bf16" if bf16 else "")
            # as the main path calls it: with amax, which the launch raises
            # to the image's |max| (here saturated at lim)
            a, b = torch.zeros((), device=device), torch.zeros((), device=device)
            got = ops.int_compress.cuda(x, alpha, seed, amax=a, **kw)
            want = ops.int_compress.plain(x, alpha, seed, amax=b, **kw)
            err = checks.equal(f"int_compress [{variant}]", got, want)
            checks.equal(f"int_compress [{variant}] amax", a, b)
            checks.equal(f"int_compress [{variant}] without amax",
                         ops.int_compress.cuda(x, alpha, seed, **kw), want)
            if bf16:  # the widening is exact: the float32 kernel's image on x.float()
                checks.equal(f"int_compress [{variant}] == [float32] on x.float()", got,
                             ops.int_compress.cuda(x.float(), alpha, seed, **kw))
            del got, want
            if big and stochastic:
                nbytes = bytes_moved("int_compress", d, 4, float_bytes=x.element_size())
                ms = interleaved_ms(torch, [
                    lambda: ops.int_compress.cuda(x, alpha, seed, amax=a, **kw),
                    lambda: ops.int_compress.cuda(x, alpha, seed, **kw)])
                timings.add("int_compress", variant, d, nbytes, err,
                            plain_fn=lambda: ops.int_compress.plain(x, alpha, seed, amax=b, **kw),
                            ms=ms[0])
                timings.add("int_compress", variant + ", no amax", d, nbytes, err,
                            plain_fn=lambda: ops.int_compress.plain(x, alpha, seed, **kw),
                            ms=ms[1])
            else:
                timings.add("int_compress", variant, d, 0, err)
            # an unclipped image (32-bit wire) whose |max| is one planted
            # element in the grid-stride loop's last round, amax starting
            # above the rest of the image: each thread's running max across
            # the rounds must carry it to the one atomicMax
            xp = x.clone()
            xp[d - 5] = -0.25  # -2250 exactly, past the N(0, 27) image's tail
            kw32 = dict(kw, bits=32)
            a, b = torch.full((), 1000.0, device=device), torch.full((), 1000.0, device=device)
            got = ops.int_compress.cuda(xp, alpha, seed, amax=a, **kw32)
            want = ops.int_compress.plain(xp, alpha, seed, amax=b, **kw32)
            err = checks.equal(f"int_compress [{variant}] bits=32, one planted peak", got, want)
            checks.equal(f"int_compress [{variant}] bits=32 amax", a, b)
            checks.true(f"int_compress [{variant}] bits=32 amax {a.item()} == 2250.0",
                        a.item() == 2250.0)
            timings.add("int_compress", variant, d, 0, err)
            del got, want, xp
        del x, x32

        for bits in (4, 8, 16):
            lim = clip_limit(bits, N_WORKERS)
            images = [
                torch.randint(-lim, lim + 1, (d,), generator=gen, device=device,
                              dtype=torch.int32)
                for _ in range(N_WORKERS)
            ]
            # saturated fields: every worker at +lim in the first and last
            # quarter (fields 0 and k-1; the top field's sum sets bit 31) and
            # at -lim in the second (every field's sum at its floor, 0)
            q = d // 4
            for img in images:
                img[:q] = lim
                img[q:2 * q] = -lim
                img[3 * q:] = lim
            kw = dict(bits=bits, n_workers=N_WORKERS)
            words = []
            for w, img in enumerate(images):
                got = ops.pack_words.cuda(img, **kw)
                want = ops.pack_words.plain(img, **kw)
                err = checks.equal(f"pack_words bits={bits} worker {w}", got, want)
                words.append(got)
                timings.add("pack_words", f"packed{bits}", d, 0, err)
                del want
            tag = f"packed{bits}"
            if big and bits == 8:
                img0 = images[0]
                timings.add("pack_words", tag, d, bytes_moved("pack_words", d, 4 / (32 // bits)),
                            err, lambda: ops.pack_words.cuda(img0, **kw),
                            lambda: ops.pack_words.plain(img0, **kw))
            wsum = psum_wire_words({"w": wds} for wds in words)["w"]
            del words
            ukw = dict(bits=bits, n_summed=N_WORKERS)
            got = ops.unpack_words.cuda(wsum, (d,), **ukw)
            want = ops.unpack_words.plain(wsum, (d,), **ukw)
            err = checks.equal(f"unpack_words bits={bits}", got, want)
            isum = images[0].to(torch.int64)
            for img in images[1:]:
                isum = isum + img.to(torch.int64)
            checks.equal(f"psum law unpack(sum pack) == sum ints, bits={bits}",
                         got.to(torch.int64), isum)
            del images, isum, want, got
            if big and bits == 8:
                timings.add("unpack_words", tag, d, bytes_moved("unpack_words", d, 4 / (32 // bits)),
                            err, lambda: ops.unpack_words.cuda(wsum, (d,), **ukw),
                            lambda: ops.unpack_words.plain(wsum, (d,), **ukw))
            else:
                timings.add("unpack_words", tag, d, 0, err)
            if bits == 8:  # the main path's codec: every packed fused variant
                fused_variants(
                    torch, ops, checks, timings, gen, device, d, big, payload=wsum,
                    lane_bytes=4 / (32 // bits), tag=tag, ops_and_kw=(
                        (ops.fused_unpack_sgd, dict(bits=8, n_summed=N_WORKERS), (False, True)),
                        (ops.fused_unpack_adamw, dict(bits=8, n_summed=N_WORKERS), (False, True)),
                    ), param_dtypes=("float32", "bfloat16"),
                )
            del wsum
            torch.cuda.empty_cache()

        # dense lanes: four workers' images summed in the lane type, with
        # sums at the lane's extremes ±n·lim in the first and second quarter
        for bits in (8, 16, 32):
            wf = DenseInt(bits)
            lim = wf.clip_limit(N_WORKERS)
            q = d // 4
            lanes = None
            for _ in range(N_WORKERS):
                img = torch.randint(-lim, lim + 1, (d,), generator=gen, device=device,
                                    dtype=torch.int32)
                img[:q] = lim
                img[q:2 * q] = -lim
                packed = {"w": wf.pack(img, n_workers=N_WORKERS)}
                lanes = psum_wire_words([packed] if lanes is None else [{"w": lanes}, packed])["w"]
                del img, packed
            tag = f"int{bits}"
            checks.true(f"dense {tag} word sum keeps the lane type and reaches ±n·lim",
                        lanes.dtype == wf.lane_dtype
                        and int(lanes[:q].min()) == N_WORKERS * lim
                        and int(lanes[q:2 * q].max()) == -N_WORKERS * lim)
            fused_variants(
                torch, ops, checks, timings, gen, device, d, big, payload=lanes,
                lane_bytes=wf.lane_dtype.itemsize, tag=tag, ops_and_kw=(
                    (ops.fused_apply_sgd, {}, (False, True)),
                    (ops.fused_apply_adamw, {}, (False, True)),
                ), param_dtypes=("float32", "bfloat16") if bits == 8 else ("float32",),
            )
            del lanes
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return timings


def block_norms_inputs(torch, gen, device, d, dtype):
    """Update-like float32 values, or a summed 4-worker packed8 image."""
    if dtype == torch.float32:
        return torch.randn(d, generator=gen, device=device) * 1e-2
    return torch.randint(-124, 125, (d,), generator=gen, device=device, dtype=torch.int32)


def leaf_sizes() -> list:
    """(elements, leaves of that size) of granite-8b at 4 layers, largest
    first: the three MLP matrices, embed and lm_head, wq and wo, wk and wv,
    ln1 and ln2, ln_f."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import param_shapes

    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=4)
    counts = collections.Counter(math.prod(s) for s in param_shapes(cfg).values())
    return sorted(counts.items(), reverse=True)


def block_norms_leaf_times(torch, kernel, device) -> dict:
    """``kernel(x, nblocks)`` at every granite-8b leaf size (4 layers),
    float32 and int32, nblocks 1, replayed from a CUDA graph: ms per launch
    and the sum over one compressed IntSGD step, which runs it once per
    leaf on float32 (||dx_l||^2) and once on int32 (||sum ints_l||^2)."""
    gen = torch.Generator(device=device).manual_seed(99)
    rows, step_ms, launches = [], 0.0, 0
    for dtype in (torch.float32, torch.int32):
        for d, leaves in leaf_sizes():
            launches += leaves
            x = block_norms_inputs(torch, gen, device, d, dtype)
            ms = graph_ms(torch, lambda: kernel(x, 1))
            del x
            step_ms += leaves * ms
            rows.append({"dtype": str(dtype).rsplit(".", 1)[1], "d": d, "leaves": leaves,
                         "ms": ms})
            print(f"  block_norms leaf time [{rows[-1]['dtype']}] d={d} x{leaves}: "
                  f"{ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    print(f"  block_norms per compressed step ({launches} launches): {step_ms:.4f} ms",
          flush=True)
    return {"leaves": rows, "step_ms": step_ms}


def block_norms_phase(torch, ops, checks, timings, device):
    """block_norms against its plain version and a float64 sum, and against
    itself (launches repeated, interleaved with other sizes, misaligned),
    on float32 and int32 inputs at the main path's magnitudes; timed at the
    largest leaf in turns with torch.dot, and at every leaf size."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_norms import MAX_BLOCKS, chunk_len

    kernel = ops.block_norms.cuda  # a direct call: no launch counted
    gen = torch.Generator(device=device).manual_seed(4321)
    # (elements, nblocks): the largest leaf and a ragged size at 1 and 4
    # blocks; 2500 elements in 4 chunks of 1024 leave the last one empty;
    # the wrapper's most blocks on a ragged size
    cases = [(d, nb) for d in (LARGEST_LEAF, RAGGED) for nb in (1, 4)] + [
        (2500, 4), (1, 1), (RAGGED, MAX_BLOCKS)]
    for dtype in (torch.float32, torch.int32):
        tag = str(dtype).rsplit(".", 1)[1]
        firsts = []  # (x, nblocks, first result) for the interleaved repeats
        for d, nb in cases:
            x = block_norms_inputs(torch, gen, device, d, dtype)
            what = f"block_norms [{tag}] d={d} nblocks={nb}"
            got = kernel(x, nb)
            err = checks.close(f"{what} vs plain", got, ops.block_norms.plain(x, nb), 1e-5)
            per = chunk_len(d, nb)
            f64 = F.pad(x.double(), (0, per * nb - d)).view(nb, per).square().sum(1)
            checks.close(f"{what} vs float64 sum", got, f64, 1e-5)
            del f64
            checks.equal(f"{what} second launch bit-identical", kernel(x, nb), got)
            if d == 2500:
                checks.true(f"{what}: the empty last chunk is 0, the others not",
                            float(got[3]) == 0.0 and bool((got[:3] > 0).all()))
            if d == LARGEST_LEAF and nb == 1:  # 4 B read per element, 4 B written
                fns = [lambda: kernel(x, 1)]
                if dtype == torch.float32:  # the library call, and a read-rate probe
                    fns += [lambda: torch.dot(x, x), lambda: torch.sum(x)]
                times = interleaved_ms(torch, fns)
                bound_ms = bound("block_norms", 4 * d + 4, d)[0]
                line = f"  block_norms [{tag}] in turns: kernel {times[0]:.4f} ms " \
                       f"({100 * bound_ms / times[0]:.1f} % of the {bound_ms:.4f} ms bound)"
                if dtype == torch.float32:
                    line += (f", torch.dot {times[1]:.4f} ms, kernel/dot "
                             f"{times[0] / times[1]:.4f}; torch.sum (read-rate probe) "
                             f"{times[2]:.4f} ms = {4 * d / times[2] / 1e9:.3f} TB/s")
                print(line, flush=True)
                timings.add("block_norms", tag, d, 4 * d + 4, err,
                            plain_fn=lambda: ops.block_norms.plain(x, 1), ms=times[0],
                            library_ms=times[1] if dtype == torch.float32 else None)
                # a misaligned view (four scalar loads a group) reads the same
                # elements in the same order as an aligned copy of them
                x1 = torch.cat([x[:1], x])[1:]
                checks.true(f"{what}: the view x[1:] is not 16-byte aligned",
                            x1.data_ptr() % 16 != 0)
                for vb in (1, 4):
                    checks.equal(f"{what} misaligned view, nblocks={vb}, bit-equal to "
                                 f"an aligned copy", kernel(x1, vb), kernel(x, vb))
                del x1
            else:
                timings.add("block_norms", tag, d, 0, err)
            firsts.append((x, nb, got))
        # launches of every size and nblocks, interleaved and repeated: each
        # bit-identical to its first result, so the ticket counters are
        # back at 0 after every launch
        ok = all(torch.equal(kernel(x, nb), got)
                 for _ in range(3) for x, nb, got in firsts[::-1] + firsts)
        checks.true(f"block_norms [{tag}]: {6 * len(firsts)} interleaved launches of "
                    f"{len(firsts)} (size, nblocks) cases bit-identical to their first", ok)
        del firsts, x, got
        torch.cuda.empty_cache()
    block_norms_leaf_times(torch, kernel, device)


# the paper's float baselines: no encode kernel (QSGD on a packed codec
# packs its levels with n_workers = 1 and unpacks each gathered worker's)
FLOAT_BASELINES = ("qsgd", "natsgd", "powersgd", "signsgd", "topk")
UNCOMPRESSED = ("none", "allgather_sgd")


def wire_limits(comp: str, wire, n_workers: int, microbatches: int):
    """(largest |image| one worker sends, largest |summed image|) a path
    allows: the §5.1 clip for the n·M sum on a psum wire, the full signed
    range on a top-k gather wire; 0 for a float compressor."""
    from repro_torch.kernels.int_compress import clip_limit

    if comp in UNCOMPRESSED or comp in FLOAT_BASELINES:
        return 0, 0
    lim = 127 if wire and wire.startswith("topk8") else clip_limit(8, n_workers * microbatches)
    return lim, n_workers * lim


def expected_launches(ops, n_leaves: int, steps: int, opt: str, comp: str, wire, *,
                      fused: bool, microbatches: int, n_local: int = N_WORKERS,
                      param_dtype: str = "float32", n_workers: int = N_WORKERS,
                      f32_leaves: int = 0):
    """Launch counts (all, with an IntDIANA shift, and of bf16 variants) a
    path implies in one process running ``n_local`` workers (all n on the local backend, one
    per rank on a process group). Per compressed step: encode for every
    (microbatch, local worker, leaf); pack for every (microbatch, local
    worker, leaf) and unpack for every (microbatch, leaf)
    on a packed wire (none on a dense one: pack is the narrowing cast,
    unpack the widening one). The fused route runs one fused update per leaf
    and block_norms once per leaf and step for ||Δx_l||², and on IntSGD
    paths once more for the clip factor (||ĝ_l||² on the exact step,
    ||Σints_l||² after; on IntDIANA paths only the exact step's, its shift
    form being plain PyTorch). The ZeRO-1 route runs no fused kernel and
    block_norms twice per leaf and step, for ||ĝ_l||² and ||Δx_l||², whatever
    the compressor; ``none`` and ``allgather_sgd`` run no integer kernel at all, nor do the float
    baselines but QSGD on a packed codec (pack per local worker and leaf,
    unpack per gathered worker and leaf). A top-k wire packs without the
    pack kernel. With bf16
    params IntSGD encodes the bf16 gradient (IntDIANA the float32 g − h_i)
    and the fused update reads and writes the bf16 param, but for the
    ``f32_leaves`` that stay float32 in a bf16 tree (the MoE router on the
    fused route, whose kernels write a param in its own type; ZeRO-1
    gathers it back as bf16 from step 0): their encodes and fused updates
    run the float32 variants."""
    c = steps - 1  # step 0 is exact: no kernel but block_norms
    want = {k.name: 0 for k in ops.KERNELS}
    want_shift, want_bf16 = dict(want), dict(want)
    bf16 = param_dtype == "bfloat16"
    n_bf16 = n_leaves - f32_leaves
    if comp in FLOAT_BASELINES:
        if wire and wire.startswith("packed"):
            want["pack_words"] = n_local * n_leaves * c
            want["unpack_words"] = n_workers * n_leaves * c
    elif comp not in UNCOMPRESSED:
        want["int_compress"] = microbatches * n_local * n_leaves * c
        if bf16 and comp != "intdiana":
            want_bf16["int_compress"] = microbatches * n_local * n_bf16 * c
        if wire and wire.startswith("packed"):
            want["pack_words"] = microbatches * n_local * n_leaves * c
            want["unpack_words"] = microbatches * n_leaves * c
    if not fused:
        want["block_norms"] = 2 * n_leaves * steps
        return want, want_shift, want_bf16
    want["block_norms"] = n_leaves * steps + (
        n_leaves if comp == "intdiana" else n_leaves * steps)
    fused_op = f"fused_unpack_{opt}" if wire.startswith("packed") else f"fused_apply_{opt}"
    want[fused_op] = n_leaves * c
    if comp == "intdiana":
        want_shift[fused_op] = n_leaves * c
    if bf16:
        want_bf16[fused_op] = n_bf16 * c
    return want, want_shift, want_bf16


def compressor_name(comp: str, wire) -> str:
    """The registry name a path trains with (IntSGD's 8-bit names where
    they exist; every other compressor its own)."""
    return {("intsgd", "packed8"): "intsgd8_packed", ("intsgd", "dense8"): "intsgd8"}.get(
        (comp, wire), comp)


class EncodeSpy:
    """Wraps the encode kernel's wrapper for a path's first compressed
    step: after every launch it reads the |max| of the image the kernel
    wrote (``torch.aminmax``, no copy), and at leaves of at most ``SMALL``
    elements holds the image against the plain version's on the same
    inputs. Launch counts are unchanged (they are counted by the
    ``KernelOp``); step 1 is not timed."""

    SMALL = 1 << 20

    def __init__(self, torch, ops):
        self.torch, self.op, self.real = torch, ops.int_compress, ops.int_compress.cuda
        self.peaks, self.small, self.small_equal = [], 0, True
        self.op.cuda = self

    @property
    def calls(self) -> int:
        return len(self.peaks)

    def __call__(self, x, alpha, seed, *, amax=None, **kw):
        out = self.real(x, alpha, seed, amax=amax, **kw)
        lo, hi = self.torch.aminmax(out)
        self.peaks.append(self.torch.maximum(lo.abs(), hi.abs()))
        if x.numel() <= self.SMALL:
            self.small += 1
            want = self.op.plain(x, alpha, seed, **kw)
            self.small_equal &= bool(self.torch.equal(out, want))
        return out

    def stop(self) -> None:
        self.op.cuda = self.real

    def peak(self) -> float:
        return float(self.torch.stack(self.peaks).max()) if self.peaks else float("nan")


class VlmRun:
    """A config with a modality frontend (internvl2-2b's patches, or the
    encoder-decoder seamless-m4t-medium's audio frames) through the user
    entry points ``launch.step.build_train_step`` and
    ``launch.inputs.materialize_batch``, as ``train_loop`` runs the others:
    weights from a seeded generator on the card (``init_encdec_params`` for
    the encoder-decoder, else ``init_lm_params``), batch i from a generator
    seeded with i, encode seeds from a host generator drawn once a step
    (``skip_seeds`` draws a resumed run's earlier ones). With ``grid`` the
    run is this rank's part of a data × model grid, as ``train_loop``'s:
    the global draw padded for the grid's tp, the rank's shard kept."""

    def __init__(self, torch, cfg, shape, *, n_workers, compressor, wire, opt, lr, fused,
                 microbatches, param_dtype, device, seed=0, grid=None):
        from repro_torch.core.compressor import leaf_seeds, make_compressor, with_wire
        from repro_torch.launch import specs
        from repro_torch.launch.step import build_init_state, build_train_step
        from repro_torch.launch.train import OPTIMIZERS
        from repro_torch.models.encdec import init_encdec_params
        from repro_torch.models.transformer import init_lm_params
        from repro_torch.optim.schedules import constant, warmup_wrap
        from repro_torch.wire import make_wire_format

        self.torch, self.cfg, self.shape, self.device = torch, cfg, shape, device
        self.n, self.micro, self.leaf_seeds = n_workers, microbatches, leaf_seeds
        comp = make_compressor(compressor)
        if wire is not None:
            comp = with_wire(comp, make_wire_format(wire) if isinstance(wire, str) else wire)
        base_opt = OPTIMIZERS[opt]()
        self.art = build_train_step(
            cfg, shape, n_workers=n_workers, compressor=comp, base_opt=base_opt,
            lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=param_dtype, fused=fused,
            clip_norm=1.0, microbatches=microbatches, device=device, grid=grid)
        init = init_encdec_params if cfg.family == "encdec" else init_lm_params
        tp = 1 if grid is None else grid.tp
        self.params = init(cfg, generator=torch.Generator(device=device).manual_seed(seed),
                           device=device, dtype=param_dtype, tp=tp)
        if tp > 1:
            self.params = specs.tp_shard(cfg, tp, grid.tp_index).tree(self.params)
        self.opt_state, self.comp_state = build_init_state(
            self.params, n_workers=n_workers, compressor=comp, base_opt=base_opt, fused=fused,
            grid=grid)
        self.seed_gen = torch.Generator().manual_seed(seed)

    def state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state, "comp": self.comp_state}

    def set_state(self, state) -> None:
        self.params, self.opt_state, self.comp_state = (
            state["params"], state["opt"], state["comp"])

    def _seeds(self, device):
        return self.leaf_seeds(self.seed_gen, self.n, len(self.art.layout.names), device,
                               self.micro)

    def skip_seeds(self, steps: int) -> None:
        for _ in range(steps):
            self._seeds("cpu")

    def step(self, i: int) -> dict:
        """Step i; its record as ``train_loop`` keeps it."""
        from repro_torch.launch.inputs import materialize_batch

        torch = self.torch
        batch = materialize_batch(self.cfg, self.shape,
                                  torch.Generator(device=self.device).manual_seed(i),
                                  self.device)
        seeds = self._seeds(self.device)
        fn = self.art.steps["exact"] if i == 0 else self.art.steps["compressed"]
        t0 = time.perf_counter()
        self.params, self.opt_state, self.comp_state, loss, m = fn(
            self.params, self.opt_state, self.comp_state, i, batch, seeds)
        torch.cuda.synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        return dict(step=i, loss=float(loss), max_int=float(m[0]), bits=float(m[1]),
                    max_local_int=float(m[3]), alpha={k: float(a) for k, a in m[2].items()},
                    ms=ms)


def vlm_loop(torch, cfg, shape, *, steps, on_step, device, n_workers, compressor, wire,
             opt, lr, fused, microbatches, param_dtype, seed, clip_norm, group, overlap,
             log_every, grid=None):
    """``train_loop``'s ``(params, history)`` for a frontend config, on the
    local backend (or a ``grid``'s groups), clip 1.0, the unbucketed wire."""
    del log_every
    if group is not None or overlap != "off" or clip_norm != 1.0:
        raise ValueError("vlm_loop runs the local backend or a grid, clip 1.0, no overlap")
    run = VlmRun(torch, cfg, shape, n_workers=n_workers, compressor=compressor, wire=wire,
                 opt=opt, lr=lr, fused=fused, microbatches=microbatches,
                 param_dtype=param_dtype, device=device, seed=seed, grid=grid)
    history = []
    for i in range(steps):
        history.append(run.step(i))
        on_step(i, run.params)
    return run.params, history


def train_phase(torch, ops, checks, device, *, label, layers, steps, opt, comp, wire, lr,
                fused, microbatches=1, param_dtype="float32", n_workers=N_WORKERS,
                overlap="off", group=None, arch="granite-8b", seq=2048):
    """One path through the user entry point (``train_loop``; for a config
    with a frontend, :func:`vlm_loop`), launch counts zeroed just before
    and read just after; returns the counts, the history and the peak
    memory in GiB. With a process ``group`` this process is one of its
    ``n_workers`` ranks."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import FLOAT32_LEAVES
    from repro_torch.utils.tree import tree_size
    from repro_torch.wire import Logged, make_wire_format

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    shape = ShapeConfig("chip-smoke", seq, n_workers * microbatches, "train")
    compressor = compressor_name(comp, wire)
    route = "fused" if fused else f"ZeRO-1, {microbatches} microbatch(es)"
    backend = "local backend" if group is None else "a one-rank NCCL group"
    print(f"{label}: {cfg.name} d_model {cfg.d_model} layers {layers} workers {n_workers} "
          f"({backend}) seq {shape.seq_len} global batch {shape.global_batch} steps {steps}: "
          f"{opt} / {compressor} / {wire}, lr {lr}, {route}, wire overlap {overlap}, "
          f"{param_dtype} params", flush=True)
    # a top-k wire runs metered: the bytes its pack and unpack see
    logged = Logged(make_wire_format(wire)) if wire and wire.startswith("topk") else None
    metered = {}

    def on_step(i, _):
        if i >= 1:
            spy.stop()
        if logged is not None:
            if i == 1:
                metered.update(pack=logged.pack_bytes, unpack=logged.unpack_bytes)
            logged.reset()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spy = EncodeSpy(torch, ops)
    ops.reset_launch_counts()
    loop = train_loop if cfg.frontend is None else functools.partial(vlm_loop, torch)
    try:
        params, history = loop(
            cfg, shape, n_workers=n_workers, compressor=compressor,
            wire=logged if logged is not None else wire, steps=steps,
            lr=lr, log_every=1, seed=0, fused=fused, clip_norm=1.0,
            microbatches=microbatches, opt=opt, param_dtype=getattr(torch, param_dtype),
            device=device, group=group, overlap=overlap, on_step=on_step,
        )
    finally:
        spy.stop()
    launches, shifts = ops.launch_counts(), ops.shift_launch_counts()
    bf16s = ops.bf16_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_leaves = len(params)
    print(f"{label}: launches {launches}; with shift {shifts}; bf16 variants {bf16s}; "
          f"{n_leaves} leaves, {tree_size(params)} parameters; peak memory {peak:.1f} GiB",
          flush=True)
    # the fused kernels write a param in its own type: a float32 leaf of a
    # bf16 tree (the MoE router) stays float32 on the fused route only
    f32_leaves = sorted(k for k in params if k in FLOAT32_LEAVES
                        and fused and param_dtype == "bfloat16")
    checks.true(f"{label}: params are {param_dtype}"
                + (f", but {f32_leaves} float32" if f32_leaves else ""),
                all(p.dtype == (torch.float32 if k in f32_leaves else getattr(torch, param_dtype))
                    for k, p in params.items()))
    if logged is not None:  # step 1: 4 workers packed, the planes gathered once
        declared = sum(logged.wire_bytes(p.numel()) for p in params.values())
        print(f"{label}: step 1 metered pack {metered['pack']} B, unpack {metered['unpack']} B; "
              f"wire_bytes {declared} B a worker", flush=True)
        checks.true(f"{label}: step 1 metered bytes: pack {metered['pack']} == {n_workers} x "
                    f"{declared}, unpack {metered['unpack']} == {n_workers} x {declared}",
                    metered["pack"] == (n_workers if group is None else 1) * declared
                    and metered["unpack"] == n_workers * declared)
    del params
    torch.cuda.empty_cache()
    for rec in history:
        print(f"  {label} step {rec['step']}: loss {rec['loss']:.4f} max_int "
              f"{rec['max_int']:.0f} max_local_int {rec['max_local_int']:.0f} bits "
              f"{rec['bits']:.0f} ms {rec['ms']:.1f}", flush=True)
    checks.true(f"{label}: losses finite", all(math.isfinite(r["loss"]) for r in history))
    # the clip for the n·M sum (the full range on a top-k wire); what one
    # reduce carries is at most n·lim, what one worker sends at most lim
    lim, lim_sum = wire_limits(comp, wire, n_workers, microbatches)
    checks.true(f"{label}: max_int <= {lim_sum} and max_local_int <= {lim} on every "
                f"compressed step", all(r["max_int"] <= lim_sum
                                        and r["max_local_int"] <= lim for r in history[1:]))
    if comp == "heuristic_intsgd":
        # JAX reports max_local_int 0 for it; its images are held to the
        # clip directly
        hlim = wire_limits(comp, wire, n_workers, 1)[0]
        checks.true(f"{label}: max_local_int 0 on every step (as JAX reports it); the "
                    f"{spy.calls} step-1 images within ±{hlim} (largest {spy.peak():.0f}); "
                    f"{spy.small} small leaves' images equal to the plain version's",
                    all(r["max_local_int"] == 0 for r in history) and spy.calls > 0
                    and spy.peak() <= hlim and spy.small > 0 and spy.small_equal)
    elif comp in FLOAT_BASELINES:
        checks.true(f"{label}: no encode at step 1 ({spy.calls}); max_int and max_local_int 0 on "
                    f"every compressed step", spy.calls == 0
                    and all(r["max_int"] == 0 == r["max_local_int"] for r in history[1:]))
    elif comp != "none":
        # step 1's max_local_int against each encode's image as written
        # (and, at the small leaves, the plain version's image)
        checks.true(f"{label}: step 1 max_local_int {history[1]['max_local_int']:.0f} == the "
                    f"largest |image| of its {spy.calls} encodes ({spy.peak():.0f}); "
                    f"{spy.small} small leaves' images equal to the plain version's",
                    spy.calls > 0 and history[1]["max_local_int"] == spy.peak()
                    and spy.small > 0 and spy.small_equal)
    if comp == "none":
        checks.true(f"{label}: max_int, max_local_int 0 and 32 bits on every compressed step",
                    all(r["max_int"] == 0 == r["max_local_int"] and r["bits"] == 32
                        for r in history[1:]))
    if comp == "intsgd_block":  # one α per leaf, from that leaf's own ||Δx_l||²
        alpha = history[1]["alpha"]
        for leaf, a in alpha.items():
            print(f"  {label} step 1 alpha[{leaf}] = {a!r}", flush=True)
        vals = list(alpha.values())
        checks.true(f"{label}: step 1 has one α per leaf, finite, positive, not all equal",
                    len(vals) == n_leaves and all(math.isfinite(a) and a > 0 for a in vals)
                    and len(set(vals)) > 1)
    want, want_shift, want_bf16 = expected_launches(
        ops, n_leaves, steps, opt, comp, wire, fused=fused, microbatches=microbatches,
        n_local=n_workers if group is None else 1, param_dtype=param_dtype,
        n_workers=n_workers, f32_leaves=len(f32_leaves))
    for name in want:
        checks.true(f"{label}: {name} launches {launches[name]} (expected {want[name]}), "
                    f"with shift {shifts[name]} (expected {want_shift[name]}), bf16 "
                    f"{bf16s[name]} (expected {want_bf16[name]})",
                    launches[name] == want[name] and shifts[name] == want_shift[name]
                    and bf16s[name] == want_bf16[name])
    return launches, history, peak


def compressed_ms(history) -> float:
    """Median wall time of a path's compressed steps but the first (which
    also pays first-use costs)."""
    return statistics.median(r["ms"] for r in history[2:])


# the headline step's packed8 words a worker sends (PERF.md §2)
HEADLINE_WIRE_BYTES = 1_275_105_280
# each audit's seconds, by label, for the phase line at the end
AUDIT_SECONDS = {}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def recorder_first_use(torch) -> float:
    """Seconds of the recorder's first use in this process, on a one-op
    function: the dispatch mode imports ``torch._dynamo`` (and sympy) once
    a process, a cost no audit should carry."""
    from repro_torch.analysis.trace import record

    t0 = time.perf_counter()
    record(lambda x: x + 1, torch.ones(1))
    return time.perf_counter() - t0


def audit_summary(rep, seconds, trace=None, audit_s=None) -> dict:
    """One static audit's numbers (``analysis.schedule.FullReport`` of a
    recorded step), plain data: what an ``audit`` line prints and what a
    rank sends back; with the ``trace``, its matmul nodes and how many the
    autograd engine's device thread ran; ``seconds`` in all, ``audit_s`` of
    them the audit after the recording."""
    t, s, a = rep.traffic, rep.schedule, rep.audit
    nodes = [] if trace is None else trace.nodes
    mm = [n.index for n in nodes if n.kind == "op" and n.op in ("mm", "addmm", "bmm")]
    off = set(() if trace is None else trace.off_thread)
    wire = [n for n in nodes if n.kind == "collective" and n.axis == "data"
            and any(lf.kind == "i" for lf in n.leaves)]
    return {
        "ok": rep.ok, "rules": sorted({v.rule for v in rep.violations}),
        "violations": [str(v) for v in rep.violations][:8],
        "int_wire_ops": a.stats["int_wire_ops"], "clips_checked": a.stats["clips_checked"],
        "wire_bytes": [t.observed_bytes, None if t.plan is None else t.plan.coll_bytes],
        "wire_collectives": [t.observed_eqns, None if t.plan is None else t.plan.n_eqns],
        "wire_leaves": [t.observed_leaves, None if t.plan is None else t.plan.n_leaves],
        "hidden_fraction": s.hidden_fraction,
        "interleavable_fraction": s.interleavable_fraction,
        "n_serialized": s.n_serialized, "backward_flops": s.backward_flops,
        "nodes": a.stats["nodes"], "kernel_nodes": a.stats["kernel_calls"],
        "mm_nodes": len(mm), "mm_nodes_off_thread": sum(i in off for i in mm),
        "wire_async_calls": sum(n.stats["async_calls"] for n in wire),
        "seconds": seconds, "audit_s": audit_s,
    }


def audit_checks(checks, label, summ, card, *, want_bytes=None, want_hidden=False,
                 device_thread=False) -> None:
    """Print an audit's line (beside the card's name and power limit) and
    hold it: the full audit passes, a clip was found on the wire, the wire's
    bytes and counts equal the declared transport's."""
    AUDIT_SECONDS[label] = summ["seconds"]
    print("audit " + json.dumps({"audit": label, **summ, "card": card}), flush=True)
    checks.true(f"audit {label}: W/P/T clean ({summ['violations']})", summ["ok"])
    checks.true(f"audit {label}: {summ['int_wire_ops']} integer wire leaves, "
                f"{summ['clips_checked']} clips checked (>= 1)",
                summ["int_wire_ops"] >= 1 and summ["clips_checked"] >= 1)
    if want_bytes is not None:
        checks.true(f"audit {label}: wire bytes {summ['wire_bytes'][0]} == {want_bytes} a "
                    f"worker per image", summ["wire_bytes"][0] == want_bytes)
    if want_hidden:
        checks.true(f"audit {label}: hidden fraction {summ['hidden_fraction']} > 0 (image 0's "
                    f"reduce unordered with image 1's backward)", summ["hidden_fraction"] > 0)
    if device_thread:
        checks.true(f"audit {label}: {summ['mm_nodes_off_thread']} of {summ['mm_nodes']} "
                    f"matmul nodes recorded in the autograd engine's device thread (> 0)",
                    summ["mm_nodes_off_thread"] > 0)


def audit_recorded(torch, checks, label, art, args, card, device, **kw) -> None:
    """Record ``art``'s compressed step on ``args`` (on their device, the
    kernels launched) and run the full W/P/T audit against its spec."""
    from repro_torch.analysis.schedule import full_audit
    from repro_torch.analysis.trace import record

    t0 = time.perf_counter()
    out, trace = record(art.steps["compressed"], *args)
    del out
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rep = full_audit(trace, art.audit_spec)
    t2 = time.perf_counter()
    audit_checks(checks, label, audit_summary(rep, t2 - t0, trace, t2 - t1), card,
                 device_thread=device.type == "cuda", **kw)


def zero1_ring_audit(torch, checks, device, card) -> None:
    """Audit (b): granite-8b at published width, 2 layers, AdamW on the
    ZeRO-1 route, IntSGD packed8, M = 2 microbatches, overlap ``ring``: one
    exact step, then the compressed step recorded and audited. Image 0's
    reduce must come out unordered with image 1's backward (hidden fraction
    above 0) and no P001."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap

    micro = 2
    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=2)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS * micro, "train")
    comp = make_compressor("intsgd8_packed")
    base_opt = OPTIMIZERS["adamw"]()
    art = build_train_step(
        cfg, shape, n_workers=N_WORKERS, compressor=comp, base_opt=base_opt,
        lr_schedule=warmup_wrap(constant(3e-4), 5), param_dtype=torch.float32, fused=False,
        clip_norm=1.0, microbatches=micro, overlap="ring", device=device)
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    opt_state, comp_state = build_init_state(params, n_workers=N_WORKERS, compressor=comp,
                                             base_opt=base_opt)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    seed_gen = torch.Generator().manual_seed(0)
    seeds0 = leaf_seeds(seed_gen, N_WORKERS, len(params), device, micro)
    seeds1 = leaf_seeds(seed_gen, N_WORKERS, len(params), device, micro)
    p1, o1, cs1, _, _ = art.steps["exact"](params, opt_state, comp_state, 0,
                                            data.batch(0, 0, device=device), seeds0)
    del params, opt_state, comp_state
    audit_recorded(torch, checks, "zero1-ring-m2", art,
                   (p1, o1, cs1, 1, data.batch(1, 0, device=device), seeds1), card, device,
                   want_hidden=True)
    del p1, o1, cs1
    torch.cuda.empty_cache()


def static_audit_phase(checks, card) -> None:
    """Audit (d): ``build_train_step(verify="static")`` for granite-8b at
    published width and full depth (the headline route: AdamW, IntSGD
    packed8, fused, float32 params, 4 workers, seq 2048), recorded on the
    meta device in this process: no card is touched. Prints its T001
    bytes."""
    import torch
    from repro_torch.analysis.wire_audit import WireAuditError
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.compressor import make_compressor
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.optim.schedules import constant

    cfg = get_arch("granite-8b")
    label = f"static granite-8b {cfg.n_layers} L (meta)"
    t0 = time.perf_counter()
    try:
        art = build_train_step(
            cfg, ShapeConfig("chip-smoke", 2048, N_WORKERS, "train"), n_workers=N_WORKERS,
            compressor=make_compressor("intsgd8_packed"), base_opt=OPTIMIZERS["adamw"](),
            lr_schedule=constant(3e-4), param_dtype=torch.float32, fused=True, clip_norm=1.0,
            device="meta", verify="static")
    except WireAuditError as e:
        checks.true(f"audit {label}: {e}", False)
        return
    summ = audit_summary(art.static_report, time.perf_counter() - t0)
    print(f"audit static: granite-8b {cfg.n_layers} L on meta, T001 bytes "
          f"{summ['wire_bytes'][0]} observed, {summ['wire_bytes'][1]} declared ({card})",
          flush=True)
    audit_checks(checks, label, summ, card)


def wire_phase(torch, checks, device, card):
    """Step 1 of the headline path replayed for one leaf: the unpacked word
    sum equals the sum of the four workers' images; then the whole step 1
    recorded and audited (audit (a), :func:`audit_recorded`)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.kernels.int_compress import clip_limit
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim.base import fused_state_init
    from repro_torch.optim.schedules import constant, warmup_wrap

    cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=4)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS, "train")
    leaf = "layers/mlp/w_up"
    lim_sum = N_WORKERS * clip_limit(8, N_WORKERS)
    comp = make_compressor("intsgd8_packed")
    base_opt = OPTIMIZERS["adamw"]()
    sched = warmup_wrap(constant(3e-4), 5)
    art = build_train_step(
        cfg, shape, n_workers=N_WORKERS, compressor=comp, base_opt=base_opt,
        lr_schedule=sched, param_dtype=torch.float32, fused=True, clip_norm=1.0,
        device=device,
    )
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    n_leaves = len(params)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    seed_gen = torch.Generator().manual_seed(0)  # train_loop's seed stream
    seeds0 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    seeds1 = leaf_seeds(seed_gen, N_WORKERS, n_leaves, device)
    p1, o1, cs1, _, _ = art.steps["exact"](
        params, fused_state_init(base_opt, params), comp.init(params, N_WORKERS), 0,
        data.batch(0, 0, device=device), seeds0,
    )
    del params
    alpha = comp.alpha_rule.alpha(cs1, sched(1, device), N_WORKERS, art.layout.dims.d)
    b1 = data.batch(1, 0, device=device)
    j = art.layout.names.index(leaf)
    images = []
    for w in range(N_WORKERS):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p1.items()}
        loss = lm_loss(leaves, {k: v[w:w + 1] for k, v in b1.items()}, cfg)
        (g,) = torch.autograd.grad(loss, [leaves[leaf]])
        images.append(comp.wire_format.encode(g, alpha, seeds1[w, j], n_workers=N_WORKERS))
        del leaves, loss, g
    words_sum, int_sum = CommCtx(n_workers=N_WORKERS).psum_wire(
        ({leaf: img} for img in images), comp.wire_format
    )
    isum = sum(img.to(torch.int64) for img in images)
    checks.equal(f"wire: step 1 {leaf}: unpacked word sum == sum of the 4 images",
                 int_sum[leaf].to(torch.int64), isum)
    checks.true(f"wire: step 1 {leaf}: |sum| <= {lim_sum} and some field nonzero",
                int(isum.abs().max()) <= lim_sum and bool(isum.any()))
    del images, words_sum, int_sum, isum
    torch.cuda.empty_cache()
    # (a) the same step 1 recorded through the CUDA kernels and audited
    audit_recorded(torch, checks, "headline", art, (p1, o1, cs1, 1, b1, seeds1), card,
                   device, want_bytes=HEADLINE_WIRE_BYTES)
    del p1, o1, cs1, b1
    torch.cuda.empty_cache()


# the paths phases 3-8 drive: (label, layers, steps, optimizer, compressor,
# wire, lr, route options); the headline path first. The four "bf16" fused
# paths run the JAX step's default bf16 params through the kernels' bf16
# variants, each beside its float32 counterpart.
FUSED = dict(fused=True)
FUSED_BF16 = dict(fused=True, param_dtype="bfloat16")
# bf16 path -> its float32 counterpart
BF16_OF = {
    "train-bf16": "train", "train-sgd-bf16": "train-sgd",
    "family sgd/intsgd/dense8 bf16": "family sgd/intsgd/dense8",
    "family adamw/intdiana/dense8 bf16": "family adamw/intdiana/dense8",
}
PATHS = (
    ("train", 4, 4, "adamw", "intsgd", "packed8", 3e-4, FUSED),
    ("train-sgd", 4, 4, "sgd", "intsgd", "packed8", 0.3, FUSED),
    ("family sgd/intsgd/dense8", 2, 3, "sgd", "intsgd", "dense8", 0.3, FUSED),
    ("family adamw/intsgd/dense8", 2, 3, "adamw", "intsgd", "dense8", 3e-4, FUSED),
    ("family sgd/intdiana/packed8", 2, 3, "sgd", "intdiana", "packed8", 0.3, FUSED),
    ("family sgd/intdiana/dense8", 2, 3, "sgd", "intdiana", "dense8", 0.3, FUSED),
    ("family adamw/intdiana/packed8", 2, 3, "adamw", "intdiana", "packed8", 3e-4, FUSED),
    ("family adamw/intdiana/dense8", 2, 3, "adamw", "intdiana", "dense8", 3e-4, FUSED),
    ("train-block", 4, 4, "sgd", "intsgd_block", "packed8", 0.3, FUSED),
    ("train-bf16", 4, 4, "adamw", "intsgd", "packed8", 3e-4, FUSED_BF16),
    ("train-sgd-bf16", 4, 4, "sgd", "intsgd", "packed8", 0.3, FUSED_BF16),
    ("family sgd/intsgd/dense8 bf16", 2, 3, "sgd", "intsgd", "dense8", 0.3, FUSED_BF16),
    ("family adamw/intdiana/dense8 bf16", 2, 3, "adamw", "intdiana", "dense8", 3e-4,
     FUSED_BF16),
    ("zero1-sgd", 4, 4, "sgd", "intsgd", "packed8", 0.3, dict(fused=False)),
    ("zero1-adamw-m2", 4, 4, "adamw", "intsgd", "packed8", 3e-4,
     dict(fused=False, microbatches=2)),
    ("zero1-intdiana-m2", 2, 3, "sgd", "intdiana", "dense8", 0.3,
     dict(fused=False, microbatches=2)),
    ("zero1-bf16", 4, 4, "sgd", "intsgd", "packed8", 0.3,
     dict(fused=False, param_dtype="bfloat16")),
    ("baseline-none", 4, 4, "sgd", "none", None, 0.3, dict(fused=False)),
    ("zero1-heuristic", 4, 4, "sgd", "heuristic_intsgd", "packed8", 0.3, dict(fused=False)),
    ("baseline-none-2l", 2, 3, "sgd", "none", None, 0.3, dict(fused=False)),
    ("zero1-qsgd", 2, 3, "sgd", "qsgd", None, 0.3, dict(fused=False)),
    ("zero1-qsgd-packed8", 2, 3, "sgd", "qsgd", "packed8", 0.3, dict(fused=False)),
    ("zero1-natsgd", 2, 3, "sgd", "natsgd", None, 0.3, dict(fused=False)),
    ("zero1-powersgd", 2, 3, "sgd", "powersgd", None, 0.3, dict(fused=False)),
    ("zero1-signsgd", 2, 3, "sgd", "signsgd", None, 0.3, dict(fused=False)),
    ("zero1-topk", 2, 3, "sgd", "topk", None, 0.3, dict(fused=False)),
    # about 0.9 % of the 117,440,512-element largest leaf
    ("zero1-intsgd-topk8", 2, 3, "sgd", "intsgd", "topk8:1048576", 0.3, dict(fused=False)),
)
# the 2-layer baselines, each timed against baseline-none-2l
BASELINE_PATHS = ("zero1-qsgd", "zero1-qsgd-packed8", "zero1-natsgd", "zero1-powersgd",
                  "zero1-signsgd", "zero1-topk", "zero1-intsgd-topk8")


def cross_route_phase(checks, histories) -> None:
    """zero1-sgd against train-sgd (the fused packed8 SGD path): the same
    seed, weights, data and encode seeds, so the same losses up to the
    update's arithmetic and the bf16 backward, which the card does not
    reproduce bit for bit; and baseline-none's step time beside
    zero1-sgd's, the cost of IntSGD's encode, pack, word sum and decode."""
    fused, zero1 = histories["train-sgd"], histories["zero1-sgd"]
    gaps = [abs(z["loss"] - f["loss"]) / abs(f["loss"]) for z, f in zip(zero1[1:], fused[1:])]
    for i, g in enumerate(gaps, 1):
        print(f"cross-route: step {i}: zero1-sgd loss {zero1[i]['loss']!r}, train-sgd loss "
              f"{fused[i]['loss']!r}, relative gap {g:.3g}", flush=True)
    checks.true("cross-route: zero1-sgd and train-sgd losses within 1e-2 relative at steps 1-3",
                len(gaps) == 3 and all(g < 1e-2 for g in gaps))
    base, intsgd = compressed_ms(histories["baseline-none"]), compressed_ms(zero1)
    fused_ms = compressed_ms(fused)
    print(f"step ms (median of steps 2-3): baseline-none {base:.1f}, zero1-sgd {intsgd:.1f} "
          f"(IntSGD's encode, pack, word sum and decode cost {intsgd - base:.1f} ms a step), "
          f"train-sgd (fused) {fused_ms:.1f} (ZeRO-1 update over the fused one "
          f"{intsgd - fused_ms:.1f} ms)", flush=True)
    heur = compressed_ms(histories["zero1-heuristic"])
    print(f"step ms (median of steps 2-3): zero1-heuristic {heur:.1f}, zero1-sgd {intsgd:.1f}: "
          f"the profiling max-reduce and the held gradients cost {heur - intsgd:.1f} ms a step "
          f"over IntSGD's adaptive α", flush=True)
    base2 = compressed_ms(histories["baseline-none-2l"])
    for label in BASELINE_PATHS:
        ms = compressed_ms(histories[label])
        print(f"step ms (step 2), 2 layers: {label} {ms:.1f}, baseline-none-2l {base2:.1f}: "
              f"{ms - base2:+.1f} ms a step", flush=True)
    # bf16 params: the fused route keeps no f32 master (as in the JAX
    # package), ZeRO-1 does, so their losses part; printed, not held
    fused16, zero16 = histories["train-sgd-bf16"], histories["zero1-bf16"]
    for i, (f, z) in enumerate(zip(fused16, zero16)):
        print(f"cross-route bf16: step {i}: train-sgd-bf16 loss {f['loss']!r}, zero1-bf16 loss "
              f"{z['loss']!r}, relative gap {abs(f['loss'] - z['loss']) / abs(z['loss']):.3g}",
              flush=True)


# phase 11: the corners four real ranks run, sharing the card through gloo:
# (label, layers, steps, optimizer, compressor, wire, lr, fused, microbatches,
# overlap). Four ranks of the AdamW/IntDIANA corner do not fit in 80 GB at
# depth 2 (each holds its params, h_local, h_global and the int32 image
# accumulator whole), so that corner runs at depth 1. So does the fused
# ring corner: at depth 2 its four ranks reserved 74.4 GiB of the card's
# 78.3 free (its old and new params and momentum are alive together), too
# little room for the ranks' CUDA contexts. The ZeRO-1 SGD corner runs at
# depth 1 to keep the script's phases under ~840 s: at depth 2 they reached
# 872.7 s on a slow host, phase 11 taking 201.0 s of it. Every corner runs 2
# steps (the exact one and one compressed), cut from 3 when phase 23 took the
# recurrent and encoder-decoder paths (phase 11 took 191.2 s at 3).
RANK_CORNERS = (
    ("ranks zero1-sgd", 1, 2, "sgd", "intsgd", "packed8", 0.3, False, 1, "off"),
    ("ranks zero1-adamw-intdiana-m2", 1, 2, "adamw", "intdiana", "dense8", 3e-4, False, 2,
     "off"),
    ("ranks fused-sgd-ring", 1, 2, "sgd", "intsgd", "packed8", 0.3, True, 1, "ring"),
    ("ranks zero1-intsgd-topk8", 1, 2, "sgd", "intsgd", "topk8:1048576", 0.3, False, 1, "off"),
)
CHECKSUM_CHUNK = 1 << 24
# the corner whose compressed step 1 each rank records and audits (audit (c))
AUDITED_CORNER = "ranks fused-sgd-ring"


def recording_build(build, box):
    """``build_train_step`` whose compressed step records and audits its
    first call (on this rank, on its group), the summary into ``box``."""
    def wrapped(*a, **kw):
        art = build(*a, **kw)
        step = art.steps["compressed"]

        def first_recorded(*args):
            if box:
                return step(*args)
            from repro_torch.analysis.schedule import full_audit
            from repro_torch.analysis.trace import record

            t0 = time.perf_counter()
            out, trace = record(step, *args)
            t1 = time.perf_counter()
            rep = full_audit(trace, art.audit_spec)
            t2 = time.perf_counter()
            box.append(audit_summary(rep, t2 - t0, trace, t2 - t1))
            return out

        return dataclasses.replace(art, steps={**art.steps, "compressed": first_recorded})

    return wrapped


def params_checksums(torch, params) -> list:
    """Two int64 checksums per leaf of the float32 params' bits, on the
    card: the sum of the int32 words and their position-weighted sum
    (wrapping), in chunks. Two ranks agree on them when their params are
    bit-identical."""
    out = []
    for k in sorted(params):
        words = params[k].reshape(-1).view(torch.int32)
        s1 = torch.zeros((), dtype=torch.int64, device=words.device)
        s2 = torch.zeros_like(s1)
        for off in range(0, words.numel(), CHECKSUM_CHUNK):
            w = words[off:off + CHECKSUM_CHUNK].to(torch.int64)
            pos = torch.arange(off + 1, off + 1 + w.numel(), device=w.device)
            s1 += w.sum()
            s2 += (w * pos).sum()
        out.append((int(s1), int(s2)))
    return out


def rank_corners(group, rank, corners, device):
    """One rank of phase 11: each corner through ``train_loop`` on the
    process group, on the one card ``device``; per corner the history, the
    params' checksums after every step, the launch counts and the peak
    memory."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import train_loop

    device = torch.device(device)
    torch.cuda.set_device(device)
    out = []
    for label, layers, steps, opt, comp, wire, lr, fused, micro, overlap in corners:
        cfg = dataclasses.replace(get_arch("granite-8b"), n_layers=layers)
        shape = ShapeConfig("chip-smoke", 2048, N_WORKERS * micro, "train")
        sums = []

        def on_step(i, p):
            sums.append(params_checksums(torch, p))
            # four ranks share 80 GB: a rank's cached blocks go back to the
            # card after every step, for the others' peaks
            torch.cuda.empty_cache()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        audit, build = [], train_mod.build_train_step
        if label == AUDITED_CORNER:
            first_use = recorder_first_use(torch)
            train_mod.build_train_step = recording_build(build, audit)
        try:
            params, history = train_loop(
                cfg, shape, n_workers=N_WORKERS, compressor=compressor_name(comp, wire),
                wire=wire, steps=steps, lr=lr, log_every=1, seed=0, fused=fused, clip_norm=1.0,
                microbatches=micro, opt=opt, device=device, group=group, overlap=overlap,
                on_step=on_step,
            )
        finally:
            train_mod.build_train_step = build
        if audit:
            audit[0]["first_use_s"] = first_use
        out.append(dict(history=history, checksums=sums, n_leaves=len(params),
                        audit=audit[0] if audit else None,
                        launches=ops.launch_counts(), shifts=ops.shift_launch_counts(),
                        peak=torch.cuda.max_memory_allocated() / 2**30,
                        reserved=torch.cuda.max_memory_reserved() / 2**30))
        del params
    torch.cuda.empty_cache()
    return out


def ranks_references(torch, ops, checks, device):
    """Phase 11's references: each corner on the local backend at n = 4
    (with every check of ``train_phase``). Returns ``(histories by label,
    launch counts)``."""
    launches = collections.Counter()
    local = {}
    for label, layers, steps, opt, comp, wire, lr, fused, micro, overlap in RANK_CORNERS:
        counts, local[label], _ = train_phase(
            torch, ops, checks, device, label=f"{label} (local n = 4)", layers=layers,
            steps=steps, opt=opt, comp=comp, wire=wire, lr=lr, fused=fused,
            microbatches=micro, overlap=overlap)
        launches.update(counts)
    return local, launches


def ranks_checks(torch, ops, checks, ranks, local, free, card) -> collections.Counter:
    """Phase 11's checks on each rank's :func:`rank_corners` result (four
    real ranks on a flat group sharing the card through gloo) against the
    local backend, and each rank's audit (c) of the audited corner's step
    1. Returns the ranks' launch counts."""
    launches = collections.Counter()
    print(f"ranks: {N_WORKERS} gloo ranks on one card; every payload reached gloo as a CUDA "
          f"tensor (the port stages none through host memory itself; gloo copies CUDA tensors "
          f"through the host)", flush=True)
    for ci, (label, layers, steps, opt, comp, wire, lr, fused, micro, overlap) in enumerate(
            RANK_CORNERS):
        res = [r[ci] for r in ranks]
        hists = [r["history"] for r in res]
        for step in range(steps):
            sums = [r["checksums"][step] for r in res]
            checks.true(f"{label}: step {step}: params bit-identical on the {N_WORKERS} ranks "
                        f"({len(sums[0])} leaves' checksums)", all(x == sums[0] for x in sums))
            recs = [h[step] for h in hists]
            checks.true(f"{label}: step {step}: alpha, max_int and max_local_int identical on "
                        f"every rank", all(r["alpha"] == recs[0]["alpha"]
                                           and r["max_int"] == recs[0]["max_int"]
                                           and r["max_local_int"] == recs[0]["max_local_int"]
                                           for r in recs))
        lim_sum = wire_limits(comp, wire, N_WORKERS, micro)[1]
        checks.true(f"{label}: max_int <= {lim_sum} on every compressed step",
                    all(r["max_int"] <= lim_sum for r in hists[0][1:]))
        gaps = [abs(g["loss"] - w["loss"]) / abs(w["loss"])
                for g, w in zip(hists[0], local[label])]
        print(f"  {label}: losses {[r['loss'] for r in hists[0]]!r} on the ranks, "
              f"{[r['loss'] for r in local[label]]!r} local; relative gaps "
              f"{[float(f'{g:.3g}') for g in gaps]}", flush=True)
        checks.true(f"{label}: losses within 1e-2 relative of the local backend's at every step",
                    len(gaps) == steps and all(g < 1e-2 for g in gaps))
        want, want_shift, _ = expected_launches(ops, res[0]["n_leaves"], steps, opt, comp,
                                                wire, fused=fused, microbatches=micro,
                                                n_local=1)
        print(f"  {label}: the {N_WORKERS} ranks' reserved peaks sum to "
              f"{sum(r['reserved'] for r in res):.1f} GiB of the {free / 2**30:.2f} GiB free "
              f"before the spawn (each rank's CUDA context comes on top)", flush=True)
        if label == AUDITED_CORNER:
            for rank, r in enumerate(res):
                checks.true(f"{label}: rank {rank} recorded its step 1", r["audit"] is not None)
                if r["audit"] is not None:
                    audit_checks(checks, f"{label} rank {rank} (gloo)", r["audit"], card,
                                 device_thread=True)
        for rank, r in enumerate(res):
            ok = all(r["launches"][k] == want[k] and r["shifts"][k] == want_shift[k] for k in want)
            checks.true(f"{label}: rank {rank} launches {r['launches']} (expected {want}), "
                        f"with shift {r['shifts']} (expected {want_shift})", ok)
            launches.update(r["launches"])
            print(f"  {label}: rank {rank}: peak {r['peak']:.1f} GiB ({r['reserved']:.1f} "
                  f"reserved), step ms "
                  f"{[round(h['ms'], 1) for h in r['history']]} (4 processes time-sharing one "
                  f"card, collectives host-staged by gloo: not a transport speed)", flush=True)
    return launches


def nccl_phase(torch, ops, checks, device) -> dict:
    """Phase 12: a one-rank NCCL group in this process: int32 words and
    int8 lanes through its all-reduce, and zero1-sgd's corner (2 layers,
    3 steps) on it beside the local backend at n = 1. Returns the launch
    counts of both."""
    import tempfile
    from repro_torch.parallel import collectives as coll

    launches = collections.Counter()
    gen = torch.Generator(device=device).manual_seed(77)
    words = torch.randint(-(2**31), 2**31 - 1, (RAGGED,), generator=gen, device=device,
                          dtype=torch.int32)
    lanes = torch.randint(-127, 128, (RAGGED,), generator=gen, device=device, dtype=torch.int8)
    corner = dict(layers=2, steps=3, opt="sgd", comp="intsgd", wire="packed8", lr=0.3,
                  fused=False, n_workers=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        group = coll.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                        world_size=1, device=device, timeout_s=300)
        try:
            checks.true(f"nccl-1: backend {coll.group_backend(group)}, world size "
                        f"{coll.group_size(group)}",
                        coll.group_backend(group) == "nccl" and coll.group_size(group) == 1)
            got = coll.psum_wire_words([{"words": words, "lanes": lanes}], group)
            checks.equal("nccl-1: int32 words all-reduced over one rank == the words sent",
                         got["words"], words)
            checks.equal("nccl-1: int8 lanes all-reduced over one rank == the lanes sent",
                         got["lanes"], lanes)
            counts, hist, _ = train_phase(torch, ops, checks, device, label="nccl-1 zero1-sgd",
                                          group=group, **corner)
            launches.update(counts)
        finally:
            coll.destroy_process_group()
    counts, local, _ = train_phase(torch, ops, checks, device,
                                   label="nccl-1 zero1-sgd (local n = 1)", **corner)
    launches.update(counts)
    gaps = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(hist, local)]
    checks.true(f"nccl-1: losses within 1e-2 relative of the local backend at n = 1 "
                f"(gaps {[float(f'{g:.3g}') for g in gaps]})",
                len(gaps) == 3 and all(g < 1e-2 for g in gaps))
    print(f"nccl-1: step ms on the one-rank NCCL group {[round(r['ms'], 1) for r in hist]}, "
          f"local n = 1 {[round(r['ms'], 1) for r in local]}", flush=True)
    return launches


def simulator_phase(torch, ops, checks, device) -> dict:
    """Phase 13: the n-worker simulator (``core.simulate.SimTrainer``, the
    unfused ``aggregate`` path) on the card. The convergence milestone at
    the sizes and bounds of ``tests/test_convergence.py``, then logistic
    regression at n = 12 workers, 4,096 rows a worker, d = 300, IntSGD with
    momentum 0.9 against ``none`` over 200 steps (10 % terminal-loss band),
    timed. Launch counts are zeroed before each run and read after it: the
    encode kernel runs n per compressed step (dense int32 wire: no pack),
    block_norms once per step for ||Δx||². Returns the launch counts."""
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import IntSGD, leaf_seeds, make_compressor
    from repro_torch.core.scaling import AlphaLastStep, AlphaState
    from repro_torch.core.simulate import SimTrainer
    from repro_torch.data.logreg import make_logreg
    from repro_torch.optim.schedules import constant
    from repro_torch.optim.sgd import sgd

    launches = collections.Counter()
    gen = torch.Generator(device=device).manual_seed(0)

    def quadratic(n, d, scale):
        bs = torch.randn(n, d, generator=gen, device=device) * scale
        return (lambda p, b: 0.5 * torch.sum((p["x"] - b) ** 2)), bs

    def run(label, loss, data, n, comp, d, steps, lr, momentum=0.0):
        """``steps`` rounds; returns the trainer's state, each round's
        max_local_int and ms a round. Checks the launch counts."""
        tr = SimTrainer(loss, n, comp, sgd(momentum=momentum), constant(lr), device=device)
        st = tr.init({"x": torch.zeros(d, device=device)})
        ops.reset_launch_counts()
        local = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            st, m = tr.step(st, data)
            local.append(0.0 if m is None else m.max_local_int)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = ops.launch_counts()
        launches.update(counts)
        want = {k: 0 for k in counts}
        want["block_norms"] = steps
        if comp.name != "none":
            want["int_compress"] = n * (steps - 1)
        checks.true(f"sim {label}: launches {counts} (expected {want})", counts == want)
        return st, [float(v) for v in local], ms

    # Thm 2: every IntSGD variant reaches the optimum like exact SGD
    n = 8
    loss, bs = quadratic(n, 20, 1.0)
    for name in ("none", "intsgd", "intsgd_determ", "intsgd_block"):
        st, _, ms = run(f"quadratic {name}", loss, bs, n, make_compressor(name), 20, 400, 0.2)
        err = float(torch.linalg.norm(st.params["x"] - bs.mean(0)))
        checks.true(f"sim quadratic {name}: |x - x*| = {err:.3g} < 1e-5 after 400 steps "
                    f"({ms:.2f} ms a step)", err < 1e-5)

    # Table 2's parity: momentum 0.9 on heterogeneous logreg, 10 % band
    def logreg_band(label, n, m, d, steps):
        prob = make_logreg(torch.Generator(device=device).manual_seed(1), n_workers=n, m=m,
                           d=d, device=device)
        out = {}
        for name in ("none", "intsgd"):
            st, _, ms = run(f"{label} {name}", prob.worker_loss, prob.worker_data(), n,
                            make_compressor(name), d, steps, 0.3, momentum=0.9)
            out[name] = (float(prob.full_loss(st.params["x"])), ms)
        gap = abs(out["intsgd"][0] - out["none"][0]) / out["none"][0]
        checks.true(f"sim {label}: terminal loss intsgd {out['intsgd'][0]!r}, none "
                    f"{out['none'][0]!r}: gap {gap:.3g} < 0.10; ms a step intsgd "
                    f"{out['intsgd'][1]:.2f}, none {out['none'][1]:.2f}", gap < 0.10)

    logreg_band("logreg n=8 m=64 d=50", 8, 64, 50, 250)

    # Cor. 2: the aggregate's quantization variance does not grow with n
    g = torch.full((64,), 0.37, device=device)
    host = torch.Generator().manual_seed(0)

    def var_for(n):
        ctx = CommCtx(n_workers=n)
        state = AlphaState(r=torch.tensor(1e-4, device=device),
                           step=torch.tensor(1, dtype=torch.int32, device=device))
        errs = [
            IntSGD().aggregate(state, ({"w": g} for _ in range(n)),
                               seeds=leaf_seeds(host, n, 1, device),
                               eta=torch.tensor(0.1, device=device), ctx=ctx)[0]["w"] - g
            for _ in range(50)]
        return float(torch.var(torch.stack(errs), unbiased=False))

    v2, v16 = var_for(2), var_for(16)
    checks.true(f"sim variance: n=16 {v16:.3g} < 4 x n=2 {v2:.3g}", 0 < v2 and v16 < 4 * v2)

    # Fig. 6: IntGD's per-worker payload blows up, IntDIANA's stays small
    loss, bs = quadratic(n, 30, 3.0)
    trace = {}
    for label, comp in (("intgd", IntSGD(alpha_rule=AlphaLastStep())),
                        ("intdiana", make_compressor("intdiana"))):
        st, local, _ = run(f"heterogeneous {label}", loss, bs, n, comp, 30, 120, 0.5)
        err = float(torch.linalg.norm(st.params["x"] - bs.mean(0)))
        trace[label] = (local, err)
        print(f"  sim heterogeneous {label}: |x - x*| = {err:.3g}, max_local_int at steps "
              f"1, 60, 119: {local[1]:.0f}, {local[60]:.0f}, {local[-1]:.0f}", flush=True)
    checks.true("sim heterogeneous: both converge (< 1e-4), IntGD's last max_local_int > 1e4, "
                "IntDIANA's < 64 throughout",
                trace["intgd"][1] < 1e-4 and trace["intdiana"][1] < 1e-4
                and trace["intgd"][0][-1] > 1e4 and max(trace["intdiana"][0]) < 64)

    # the w8a-width logreg at a real per-worker size
    logreg_band("logreg n=12 m=4096 d=300", 12, 4096, 300, 200)
    return launches


# half of layers/mlp/w_* at 1 layer: 29,360,128 elements (cut from 2 layers,
# whose CPU side took ~130 s, then from the whole 1-layer leaf, whose phase
# took 117.3 s, to keep the script's phases under ~780 s with phase 23's
# recurrent and encoder-decoder paths)
BASELINE_LEAF = (1, 4096, 7168)


def baseline_phase(torch, checks, device) -> None:
    """Phase 14: each baseline's aggregate at the largest 1-layer leaf on
    the card and on CPU copies (same gradients, seeds and state), held as
    the module docstring says, with both times printed; then TopKInt's
    planes, and a tied image's top-k selection."""
    from repro_torch.core.comm import CommCtx
    from repro_torch.core.compressor import (
        counter_uniform, leaf_seeds, make_compressor, qsgd_norm,
    )
    from repro_torch.wire import TopKInt
    from repro_torch.wire.topk import select_topk

    cpu = torch.device("cpu")
    d = math.prod(BASELINE_LEAF)
    gen = torch.Generator(device=device).manual_seed(2024)
    grads = {"card": [torch.randn(BASELINE_LEAF, generator=gen, device=device) * 1e-3
                      for _ in range(N_WORKERS)]}
    grads["host"] = [g.cpu() for g in grads["card"]]
    seeds = leaf_seeds(torch.Generator().manual_seed(5), N_WORKERS, 1, cpu)
    ctx = CommCtx(n_workers=N_WORKERS)
    print(f"baselines: one {BASELINE_LEAF} leaf ({d} elements), {N_WORKERS} workers, "
          f"card against the CPU", flush=True)

    def both(name, **kw):
        """The aggregate on the card, then on the CPU: ((ĝ, state, m) on
        each, moved to the CPU)."""
        comp = make_compressor(name, **kw)
        out = []
        for dev, key in ((device, "card"), (cpu, "host")):
            state = comp.init({"w": grads[key][0]}, N_WORKERS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ghat, state, m = comp.aggregate(
                state, ({"w": g} for g in grads[key]), seeds=seeds.to(dev),
                eta=torch.tensor(0.1, device=dev), ctx=ctx)
            torch.cuda.synchronize()
            out.append((ghat["w"].cpu(), state, m, time.perf_counter() - t0))
        print(f"  baselines {name}{kw or ''}: aggregate {1e3 * out[0][3]:.1f} ms on the card, "
              f"{out[1][3]:.1f} s on the CPU", flush=True)
        return comp, out[0], out[1]

    def within(what, got, want, frac):
        """|got - want| <= frac · max|want| everywhere: a reduction summed in
        another order moves each value by a few ULPs of the largest."""
        err = (got.double() - want.double()).abs().max().item()
        ok = got.shape == want.shape and err <= frac * want.abs().max().item()
        checks.true(f"{what}: max_abs_err {err:.3g} <= {frac} x max|value| "
                    f"{want.abs().max().item():.3g}", ok)

    # Heuristic IntSGD (packed8): elementwise given the max
    _, card, host = both("heuristic_intsgd", wire="packed8")
    checks.equal("baselines heuristic_intsgd packed8 ĝ", card[0], host[0])
    checks.true(f"baselines heuristic_intsgd max_int {float(card[2].max_int)} == CPU's, <= 124",
                float(card[2].max_int) == float(host[2].max_int) <= 124)
    # QSGD: the levels bit-equal given the same norm and uniforms
    comp, card, host = both("qsgd")
    g = grads["host"][0]
    norm = qsgd_norm(g)
    u = counter_uniform(g.shape, seeds[0, 0], cpu)  # worker 0's, NatSGD's too
    u_card = counter_uniform(g.shape, seeds[0, 0].to(device), device)
    checks.equal("baselines counter uniforms (worker 0)", u_card.cpu(), u)
    checks.equal("baselines qsgd levels given the CPU's norm and uniforms",
                 comp.quantize(grads["card"][0], norm.to(device), u_card).cpu(),
                 comp.quantize(g, norm, u))
    step = max(float(qsgd_norm(x)) for x in grads["host"]) / (
        comp.levels * N_WORKERS)
    diff = (card[0].double() - host[0].double()).abs()
    big = int((diff > 1e-6 * host[0].abs().max().item()).sum())
    checks.true(f"baselines qsgd ĝ: max_abs_err {diff.max().item():.3g} within one level step "
                f"{step:.3g}; {big} of {d} elements past 1e-6 x max|value| (flipped levels)",
                diff.max().item() <= step * (1 + 1e-5) and big <= 64)
    del diff
    # NatSGD: elementwise throughout
    comp, card, host = both("natsgd")
    checks.equal("baselines natsgd ĝ", card[0], host[0])
    for part, got, want in zip(("exponents", "signs"),
                               comp.natural(grads["card"][0], u_card), comp.natural(g, u)):
        checks.equal(f"baselines natsgd {part} (worker 0)", got.cpu(), want)
    del u, u_card
    # PowerSGD and SignSGD: reductions in another order
    _, card, host = both("powersgd")
    within("baselines powersgd ĝ", card[0], host[0], 1e-5)
    within("baselines powersgd error feedback", card[1]["err"]["w"].cpu(), host[1]["err"]["w"],
           1e-5)
    _, card, host = both("signsgd")
    within("baselines signsgd ĝ", card[0], host[0], 1e-5)
    within("baselines signsgd error feedback", card[1]["w"].cpu(), host[1]["w"], 1e-5)
    checks.equal("baselines signsgd signs sent (sign of w - e')",
                 torch.sign(grads["card"][0] - card[1]["w"][0]).cpu(),
                 torch.sign(g - host[1]["w"][0]))
    # TopK: selection, scatter-add in worker order, error feedback
    comp, card, host = both("topk")
    checks.equal("baselines topk ĝ", card[0], host[0])
    checks.equal("baselines topk error feedback", card[1]["w"].cpu(), host[1]["w"])
    checks.equal("baselines topk indices (worker 0)", comp.select(grads["card"][0])[0].cpu(),
                 comp.select(g)[0])
    del card, host

    # TopKInt: the encode (n_workers = 1), the planes, the gathered sum
    wf = TopKInt(bits=8, k=1 << 20)
    alpha, seed = torch.tensor(1e4), torch.tensor(-77, dtype=torch.int32)
    sums, planes = [], []
    for dev, key in ((device, "card"), (cpu, "host")):
        ints = [wf.encode(x, alpha.to(dev), seed.to(dev), n_workers=N_WORKERS, stochastic=False)
                for x in grads[key]]
        payloads = [wf.pack(v, n_workers=N_WORKERS) for v in ints]
        planes.append((ints[0].cpu(), payloads[3]["idx"].cpu(), payloads[3]["vals"].cpu()))
        sums.append(wf.unpack({p: torch.stack([pl[p] for pl in payloads]) for p in ("idx", "vals")},
                              BASELINE_LEAF, n_summed=N_WORKERS).cpu())
        del ints, payloads
    for what, got, want in zip(("encode (worker 0)", "idx plane (worker 3)",
                                "vals plane (worker 3)"), *planes):
        checks.equal(f"baselines topk8 {what}", got, want)
    checks.equal("baselines topk8 unpacked 4-worker sum", sums[0], sums[1])
    checks.true(f"baselines topk8: the sum holds 4 x 2^20 survivors at most, some nonzero "
                f"({int((sums[1] != 0).sum())})", 0 < int((sums[1] != 0).sum()) <= 4 << 20)
    del sums, planes, grads

    # planted ties: values in -3..3, the top 2^20 of |v|
    v = torch.randint(-3, 4, (d,), generator=gen, device=device, dtype=torch.int32).abs()
    k = 1 << 20
    got = select_topk(v, k)
    checks.equal(f"baselines tied image (-3..3, {d}): top-{k} indices", got.cpu(),
                 select_topk(v.cpu(), k))
    t = v[got[-1]]
    kept = torch.sort(got[v[got] == t]).values
    first = (v == t).nonzero().reshape(-1)[:kept.numel()]
    checks.equal(f"baselines tied image: the {kept.numel()} kept ties of |v| = {int(t)} are the "
                 f"lowest-indexed, on the card", kept, first)
    del v, got
    torch.cuda.empty_cache()


# phase 15: the rest of the dense decoder family at published width, depth
# cut to 2 layers, 4 workers, 4 steps, IntSGD on packed8: (label, config,
# sequence length, optimizer, lr, route). danube runs past its 4,096 window;
# internvl2 takes 256 patches and 1,792 text tokens.
DENSE_PATHS = (
    ("qwen-fused-sgd", "qwen2.5-32b", 2048, "sgd", 0.3, FUSED_BF16),
    ("minitron-zero1-adamw", "minitron-4b", 2048, "adamw", 3e-4, dict(fused=False)),
    ("danube-window", "h2o-danube-3-4b", 8192, "sgd", 0.3, dict(fused=False)),
    ("internvl2-vlm", "internvl2-2b", 2048, "sgd", 0.3, dict(fused=False)),
)
DENSE_LARGEST_LEAF = 256_000 * 3_072  # minitron-4b's embed and lm_head
WINDOW_T = 8192  # the window check's sequence: twice danube's window
CARD_BYTES = 80e9


def window_check(torch, checks, device) -> None:
    """Port of ``tests/test_archs.py::test_sliding_window_masks_far_tokens``
    at full width on the card: h2o-danube-3-4b's attention (the first
    layer's weights) at T = 8192 on float32 inputs, token 0 perturbed by
    100. With the 4,096 window the outputs at positions >= 4096 stay within
    1e-6 and every earlier one changes; without it the late ones change."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.attention import attention_train
    from repro_torch.models.transformer import init_lm_params

    cfg = dataclasses.replace(get_arch("h2o-danube-3-4b"), n_layers=1)
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    attn = {k.rsplit("/", 1)[1]: v[0] for k, v in params.items() if "/attn/" in k}
    del params
    t, w = WINDOW_T, cfg.window
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(1, t, cfg.d_model, generator=gen, device=device)
    x2 = x.clone()
    x2[0, 0] += 100.0
    pos = torch.arange(t, device=device)[None]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    diffs = {}
    with torch.no_grad():
        for window in (w, None):
            a = attention_train(attn, x, pos, window=window, **kw)
            b = attention_train(attn, x2, pos, window=window, **kw)
            diffs[window] = (a - b).abs().amax(-1)[0]
            del a, b
    late, early = diffs[w][w:], diffs[w][:w]
    print(f"window: danube attention at T = {t}: with the {w} window, positions >= {w} moved "
          f"at most {late.max().item():.3g}, positions < {w} at least {early.min().item():.3g}; "
          f"without it positions >= {w} at least {diffs[None][w:].min().item():.3g}", flush=True)
    checks.true(f"window: outputs at positions >= {w} unchanged within 1e-6",
                late.max().item() <= 1e-6)
    checks.true(f"window: every output at positions < {w} changed", bool((early > 0).all()))
    checks.true(f"window: without the window every output at positions >= {w} changed",
                bool((diffs[None][w:] > 0).all()))
    del x, x2, attn, diffs
    torch.cuda.empty_cache()


def card_cpu_losses(torch, checks, device, archs) -> None:
    """Each config of ``archs`` at 1 layer, batch 1, 128 text tokens
    (internvl2: after 256 patches): the forward loss on the card against the
    CPU's plain path, the same bf16 weights and batch, within 1e-2 relative
    (bf16 activations round differently on the two, and may route an MoE
    near-tie apart)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.inputs import materialize_batch
    from repro_torch.models.transformer import init_lm_params, lm_loss

    cpu_s = 0.0
    for arch in archs:
        cfg = dataclasses.replace(get_arch(arch), n_layers=1)
        shape = ShapeConfig("card-cpu", 128 + cfg.n_frontend_tokens, 1, "train")
        params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                device=device, dtype=torch.bfloat16)
        batch = materialize_batch(cfg, shape, torch.Generator(device=device).manual_seed(1),
                                  device)
        with torch.no_grad():
            card = lm_loss(params, batch, cfg).item()
            params = {k: v.cpu() for k, v in params.items()}
            t0 = time.perf_counter()
            cpu = lm_loss(params, {k: v.cpu() for k, v in batch.items()}, cfg).item()
            cpu_s += time.perf_counter() - t0
        del params, batch
        gap = abs(card - cpu) / abs(cpu)
        checks.true(f"card-cpu {arch}: loss on the card {card!r}, on the CPU {cpu!r}, "
                    f"relative gap {gap:.3g} < 1e-2", math.isfinite(card) and gap < 1e-2)
    torch.cuda.empty_cache()
    print(f"card-cpu: the CPU forwards took {cpu_s:.1f}s", flush=True)


def largest_leaf_kernels(torch, ops, checks, timings, device, d=DENSE_LARGEST_LEAF) -> None:
    """The kernels of a family's paths once more at its largest leaf of
    ``d`` elements (by default minitron-4b's 786,432,000: 3.1 GB of
    float32, byte offsets past 2^31), each held against its plain version
    and timed beside its byte bound: the encode (float32, stochastic), pack
    and unpack (packed8, 4 workers), the fused SGD update (packed8, float32
    param) and block_norms (float32, with torch.dot in turns)."""
    from repro_torch.parallel.collectives import psum_wire_words

    print(f"kernels at d = {d}", flush=True)
    gen = torch.Generator(device=device).manual_seed(2024)
    tag = lambda name: f"{MAIN_VARIANT[name]}, d={d}"
    x = torch.randn(d, generator=gen, device=device) * 3e-3
    alpha = torch.full((), 9000.0, device=device)
    seed = torch.full((), -123456789, dtype=torch.int32, device=device)
    kw = dict(n_workers=N_WORKERS, bits=8, stochastic=True)
    a, b = torch.zeros((), device=device), torch.zeros((), device=device)
    img = ops.int_compress.cuda(x, alpha, seed, amax=a, **kw)
    want = ops.int_compress.plain(x, alpha, seed, amax=b, **kw)
    err = checks.equal(f"int_compress [{tag('int_compress')}]", img, want)
    checks.equal(f"int_compress [{tag('int_compress')}] amax", a, b)
    del want
    torch.cuda.empty_cache()
    ms = interleaved_ms(torch, [lambda: ops.int_compress.cuda(x, alpha, seed, amax=a, **kw)])[0]
    timings.add("int_compress", tag("int_compress"), d, bytes_moved("int_compress", d, 4), err,
                plain_fn=lambda: ops.int_compress.plain(x, alpha, seed, amax=b, **kw), ms=ms,
                plain_reps=2)
    torch.cuda.empty_cache()

    pkw = dict(bits=8, n_workers=N_WORKERS)
    words = ops.pack_words.cuda(img, **pkw)
    err = checks.equal(f"pack_words [{tag('pack_words')}]", words,
                       ops.pack_words.plain(img, **pkw))
    timings.add("pack_words", tag("pack_words"), d, bytes_moved("pack_words", d, 1), err,
                lambda: ops.pack_words.cuda(img, **pkw), lambda: ops.pack_words.plain(img, **pkw),
                plain_reps=2)
    # four workers' words summed: the same image four times
    wsum = psum_wire_words([{"w": words}] * N_WORKERS)["w"]
    del words
    ukw = dict(bits=8, n_summed=N_WORKERS)
    got = ops.unpack_words.cuda(wsum, (d,), **ukw)
    err = checks.equal(f"unpack_words [{tag('unpack_words')}]", got,
                       ops.unpack_words.plain(wsum, (d,), **ukw))
    checks.equal(f"psum law at d = {d}: unpack(sum of 4 x pack(img)) == 4 x img", got,
                 img * N_WORKERS)
    del got, img
    torch.cuda.empty_cache()
    timings.add("unpack_words", tag("unpack_words"), d, bytes_moved("unpack_words", d, 1), err,
                lambda: ops.unpack_words.cuda(wsum, (d,), **ukw),
                lambda: ops.unpack_words.plain(wsum, (d,), **ukw), plain_reps=2)

    p, state, sc, _ = fused_inputs(torch, gen, device, d, "sgd", False, torch.float32, False)
    fkw = dict(bits=8, n_summed=N_WORKERS)
    cuda = lambda: ops.fused_unpack_sgd.cuda(wsum, p, *state, sc, shift=None, **fkw)
    plain = lambda: ops.fused_unpack_sgd.plain(wsum, p, *state, sc, shift=None, **fkw)
    err = compare(checks, f"fused_unpack_sgd [{tag('fused_unpack_sgd')}]", cuda(), plain(),
                  ("param'", "mom'"))
    torch.cuda.empty_cache()
    timings.add("fused_unpack_sgd", tag("fused_unpack_sgd"), d,
                bytes_moved("fused_unpack_sgd", d, 1), err, cuda, plain, plain_reps=2)
    del p, state, sc, wsum, cuda, plain
    torch.cuda.empty_cache()

    kernel = ops.block_norms.cuda
    got = kernel(x, 1)
    err = checks.close(f"block_norms [{tag('block_norms')}] vs plain", got,
                       ops.block_norms.plain(x, 1), 1e-5)
    checks.close(f"block_norms [{tag('block_norms')}] vs float64 sum", got,
                 x.double().square().sum().reshape(1), 1e-5)
    times = interleaved_ms(torch, [lambda: kernel(x, 1), lambda: torch.dot(x, x)])
    timings.add("block_norms", tag("block_norms"), d, 4 * d + 4, err,
                plain_fn=lambda: ops.block_norms.plain(x, 1), ms=times[0], library_ms=times[1],
                plain_reps=2)
    del x, got
    torch.cuda.empty_cache()
    for name in ("int_compress", "pack_words", "unpack_words", "fused_unpack_sgd", "block_norms"):
        small = timings.main_row(name)
        big = next(r for r in timings.rows if r["name"] == name and r["variant"] == tag(name))
        print(f"  {name} [{MAIN_VARIANT[name]}]: {small['ms']:.3f} ms at d = {small['d']} "
              f"({100 * small['bound_ms'] / small['ms']:.1f} % of its bound), {big['ms']:.3f} ms "
              f"at d = {d} ({100 * big['bound_ms'] / big['ms']:.1f} % of {big['bound_ms']:.3f} "
              f"ms)", flush=True)


def pin_check(torch, ops, checks, device) -> collections.Counter:
    """The attention's backend pin (PyTorch's memory-efficient SDPA on the
    card) against PyTorch's own choice, on granite-8b's zero1-sgd corner
    (2 layers, 3 steps) in turns: pinned, free, free, pinned. Printed, not
    held (the runs differ by noise alone if the pin costs nothing). Returns
    the launch counts."""
    import repro_torch.models.attention as attention

    pinned = attention.sdpa_kernel
    launches, ms = collections.Counter(), collections.defaultdict(list)
    try:
        for tag in ("pinned", "free", "free", "pinned"):
            attention.sdpa_kernel = (pinned if tag == "pinned"
                                     else lambda *a, **k: contextlib.nullcontext())
            counts, hist, _ = train_phase(
                torch, ops, checks, device, label=f"pin-check zero1-sgd 2l {tag}", layers=2,
                steps=3, opt="sgd", comp="intsgd", wire="packed8", lr=0.3, fused=False)
            launches.update(counts)
            ms[tag].append(hist[2]["ms"])
    finally:
        attention.sdpa_kernel = pinned
    print(f"pin-check: step 2 ms, pinned {ms['pinned']}, free {ms['free']}: pinned less free "
          f"{statistics.mean(ms['pinned']) - statistics.mean(ms['free']):+.2f} ms", flush=True)
    return launches


def vocab_probe(torch, device, vocab=92553, d_model=2048, tokens=2048) -> None:
    """Where a misaligned vocabulary's step goes: the logits GEMM (``tokens``
    x ``d_model`` -> ``vocab`` in bf16, forward and the two backward
    products) against the same with the vocabulary padded to a multiple of
    8 (rows of 16-byte multiples), timed in turns. Printed. By default
    internvl2-2b's: 2048 tokens x 2048 -> 92,553, padded to 92,560."""
    padded = -(-vocab // 8) * 8
    gen = torch.Generator(device=device).manual_seed(3)
    h = torch.randn(tokens, d_model, generator=gen, device=device).to(torch.bfloat16)
    out = []
    for v in (vocab, padded):
        w = torch.randn(d_model, v, generator=gen, device=device).to(torch.bfloat16)
        g = torch.randn(tokens, v, generator=gen, device=device).to(torch.bfloat16)
        out += [lambda h=h, w=w: h @ w, lambda g=g, w=w: g @ w.T, lambda g=g: h.T @ g]
    names = ("h @ W", "dL @ W^T", "h^T @ dL")
    times = interleaved_ms(torch, out, rounds=4, batch=5)
    for i, name in enumerate(names):
        print(f"vocab-probe: {tokens} x {d_model} -> {name}: vocab {vocab:,} {times[i]:.3f} ms, "
              f"padded to {padded:,} {times[i + 3]:.3f} ms", flush=True)
    del h, out
    torch.cuda.empty_cache()


def dense_family_phase(torch, ops, checks, timings, device):
    """Phase 15: the four new configs' paths through the user entry points
    at published width, with every check of ``train_phase``; the window at
    full width; card against CPU; the kernels at the largest new leaf.
    Returns the paths' launch counts and bf16-variant counts, their
    histories and peaks."""
    launches, bf16 = collections.Counter(), collections.Counter()
    histories, peaks = {}, {}
    for label, arch, seq, opt, lr, route in DENSE_PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=2, steps=4, opt=opt,
            comp="intsgd", wire="packed8", lr=lr, arch=arch, seq=seq, **route)
        launches.update(counts)
        bf16.update(ops.bf16_launch_counts())
        checks.true(f"{label}: peak {peaks[label]:.1f} GiB below the card's 80 GB",
                    peaks[label] * 2**30 < CARD_BYTES)
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    vocab_probe(torch, device)
    t0 = time.perf_counter()
    launches.update(pin_check(torch, ops, checks, device))
    print(f"pin check: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    window_check(torch, checks, device)
    print(f"window check: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    card_cpu_losses(torch, checks, device, [arch for _, arch, *_ in DENSE_PATHS])
    print(f"card-cpu: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    largest_leaf_kernels(torch, ops, checks, timings, device)
    print(f"kernels at the largest new leaf: {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, bf16, histories, peaks


def checkpoint_phase(torch, ops, checks, device) -> dict:
    """Phase 16: internvl2-2b at published width, 1 layer, 4 workers, ZeRO-1
    SGD / IntSGD / packed8 with bf16 params (the step's default): 4 straight
    steps; then 2 steps, a save at step 2 into a temporary directory under
    build/ (removed after), a restore into fresh state that must be bit-equal
    to what was saved (params, ZeRO-1 masters and momentum rows, α state),
    and a resume to step 4 (the encode seeds of steps 0-1 drawn and
    dropped) whose losses are within 1e-2 of the straight run's (the bf16
    backward is not bit-reproducible on the card). Returns the launch
    counts, which must be the three runs' (8 steps, 6 compressed)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointStore, flatten_state
    from repro_torch.configs.base import ShapeConfig, get_arch

    cfg = dataclasses.replace(get_arch("internvl2-2b"), n_layers=1)
    shape = ShapeConfig("chip-smoke", 2048, N_WORKERS, "train")
    kw = dict(n_workers=N_WORKERS, compressor="intsgd8_packed", wire="packed8", opt="sgd",
              lr=0.3, fused=False, microbatches=1, param_dtype=torch.bfloat16, device=device)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        run = VlmRun(torch, cfg, shape, **kw)
        n_leaves = len(run.params)
        straight = [run.step(i)["loss"] for i in range(4)]
        run = VlmRun(torch, cfg, shape, **kw)
        losses = [run.step(i)["loss"] for i in range(2)]
        saved = {k: v.clone() for k, v in flatten_state(run.state()).items()}
        store = CheckpointStore(tmp)
        t0 = time.perf_counter()
        store.save(2, run.state())
        t_snap = time.perf_counter() - t0
        store.wait()
        t_write = time.perf_counter() - t0
        store.close()
        del run
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        run = VlmRun(torch, cfg, shape, **kw)  # fresh weights and state: the template
        t0 = time.perf_counter()
        state, _, step = store.restore(run.state())
        t_restore = time.perf_counter() - t0
        got = flatten_state(state)
        same = got.keys() == saved.keys() and all(
            got[k].dtype == saved[k].dtype and got[k].device == saved[k].device
            and torch.equal(got[k], saved[k]) for k in saved)
        checks.true(f"checkpoint: step {step}: {len(saved)} arrays ({nbytes} bytes on disk) "
                    f"restored bit-equal to what was saved", step == 2 and same)
        del saved, got
        run.set_state(state)
        del state
        run.skip_seeds(2)
        losses += [run.step(i)["loss"] for i in (2, 3)]
        del run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, straight)]
    print(f"checkpoint: save {t_snap:.2f}s to host memory, {t_write:.2f}s written; restore "
          f"{t_restore:.2f}s; losses {losses!r} (resumed at 2), straight {straight!r}; peak "
          f"{peak:.1f} GiB; launches {counts}", flush=True)
    checks.true(f"checkpoint: resumed losses within 1e-2 of the straight run's (gaps "
                f"{[float(f'{g:.3g}') for g in gaps]})",
                len(gaps) == 4 and all(g < 1e-2 for g in gaps))
    # 8 steps, 6 compressed: an encode and a pack per worker and leaf, an
    # unpack per leaf; block_norms twice per leaf and step
    want = {k.name: 0 for k in ops.KERNELS}
    want.update(int_compress=6 * N_WORKERS * n_leaves, pack_words=6 * N_WORKERS * n_leaves,
                unpack_words=6 * n_leaves, block_norms=2 * 8 * n_leaves)
    checks.true(f"checkpoint: launches {counts} (expected {want})", counts == want)
    return counts


# phase 17: the moe family at published width, 4 workers, 4 steps, IntSGD
# on packed8, seq 2048: (label, config, layers, optimizer, lr, route).
# mixtral's depth is cut to 1 layer (2,906,720,256 params; at 2 layers
# 5,410,781,184, ~110 GB on the fused bf16 route's ~20 B a param).
MOE_PATHS = (
    ("mixtral-fused-sgd", "mixtral-8x22b", 1, "sgd", 0.3, FUSED_BF16),
    ("deepseek-zero1-adamw", "deepseek-v2-lite-16b", 2, "adamw", 3e-4, dict(fused=False)),
)
MOE_SEQ = 2048
MIN_ROUTE_AGREEMENT = 0.999


def moe_layer_inputs(torch, cfg, device):
    """One full-width layer of ``cfg`` in bf16 on the card, seeded: its
    MoE block's params and input (the embedding through attention and the
    ln2 norm, batch 1, ``MOE_SEQ`` tokens), caught as the forward hands
    them to the MoE block (``moe_block``)."""
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.inputs import materialize_batch

    params = transformer.init_lm_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.bfloat16)
    batch = materialize_batch(cfg, ShapeConfig("moe", MOE_SEQ, 1, "train"),
                              torch.Generator(device=device).manual_seed(1), device)
    caught, real = [], transformer.moe_block

    def catch(p, x, **kw):
        caught.append(({k: v.detach() for k, v in p.items()}, x.detach()))
        return real(p, x, **kw)

    transformer.moe_block = catch
    try:
        with torch.no_grad():
            transformer.lm_forward(params, batch, cfg)
    finally:
        transformer.moe_block = real
    del params, batch
    return caught[0]


def routing_check(torch, checks, cfg, p, x) -> None:
    """The MoE block's routing of the same bf16 hidden states on the card
    and on the CPU: the share of (token, choice) expert ids that agree must
    be at least ``MIN_ROUTE_AGREEMENT`` (float32 logits from GEMMs that sum
    in other orders can flip a near-tie); the dispatch slots and drop mask
    the card computes from its ids must equal the CPU's from the same ids,
    bit for bit. Prints tokens per expert and the dropped share."""
    from repro_torch.models import moe

    n = x.shape[0] * x.shape[1]
    xf = x.reshape(n, -1)
    cap = moe.capacity(n, cfg.top_k, cfg.n_experts)
    with torch.no_grad():
        _, ids = moe.route(p["router"], xf, cfg.top_k)
        _, ids_cpu = moe.route(p["router"].cpu(), xf.cpu(), cfg.top_k)
        got = [t.cpu() for t in moe.dispatch_indices(ids, cfg.n_experts, cap)]
        want = moe.dispatch_indices(ids.cpu(), cfg.n_experts, cap)
    agree = (ids.cpu() == ids_cpu).double().mean().item()
    flips = int((ids.cpu() != ids_cpu).sum())
    per_expert = torch.bincount(got[0], minlength=cfg.n_experts).tolist()
    dropped = 1.0 - got[2].double().mean().item()
    print(f"routing {cfg.name}: {n} tokens x top-{cfg.top_k}, capacity {cap} a expert; "
          f"card and CPU agree on {agree:.6f} of (token, choice) ids ({flips} differ); "
          f"tokens per expert {per_expert}; dropped share {dropped:.6f}", flush=True)
    checks.true(f"routing {cfg.name}: ids agree on {agree:.6f} >= {MIN_ROUTE_AGREEMENT}",
                agree >= MIN_ROUTE_AGREEMENT)
    checks.true(f"routing {cfg.name}: dispatch experts, slots and drop mask from the card's "
                f"ids equal to the CPU's from the same ids",
                all(torch.equal(a, b) for a, b in zip(got, want)))


def moe_block_split(torch, cfg, p, x) -> None:
    """Where one MoE block's time goes (``cfg``'s layer at full width, the
    train path's per-worker batch): each stage's forward and backward, CUDA
    events between stages, median of 5 runs after a warm-up —
    routing (the float32 router GEMM, softmax and sort), dispatch (slots
    and the scatter into the capacity buffer), the expert SwiGLU (three
    batched bf16 GEMMs), combine (gather, weighting, sum over k). Printed."""
    from repro_torch.models import moe

    n, d = x.shape[0] * x.shape[1], x.shape[2]
    k, e = cfg.top_k, cfg.n_experts
    cap = moe.capacity(n, k, e)
    pp = {name: v.clone().requires_grad_(True) for name, v in p.items()
          if name in ("router", "w_gate", "w_up", "w_down")}
    xf = x.reshape(n, d).clone().requires_grad_(True)
    grad_out = torch.randn(n, d, generator=torch.Generator(device=x.device).manual_seed(4),
                           device=x.device).to(x.dtype)
    stages = ("route", "dispatch", "experts", "combine")
    times = {f"{s} {way}": [] for s in stages for way in ("forward", "backward")}

    def one():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        ev[0].record()
        w, ids = moe.route(pp["router"], xf, k)
        ev[1].record()
        flat_e, slot, keep = moe.dispatch_indices(ids, e, cap)
        dest = flat_e * cap + slot
        buf = moe.dispatch(xf, dest, keep, k, e * cap)
        ev[2].record()
        out_buf = moe.expert_ffn(pp, buf.reshape(e, cap, d))
        ev[3].record()
        out = moe.combine(out_buf.reshape(e * cap, d), dest, w, keep, k)
        ev[4].record()
        g_ob, g_w = torch.autograd.grad(out, [out_buf, w], grad_out)
        ev[5].record()
        g_buf, *_ = torch.autograd.grad(out_buf, [buf, pp["w_gate"], pp["w_up"],
                                                  pp["w_down"]], g_ob)
        ev[6].record()
        torch.autograd.grad(buf, [xf], g_buf)
        ev[7].record()
        torch.autograd.grad(w, [xf, pp["router"]], g_w)
        ev[8].record()
        ev[8].synchronize()
        return {"route forward": ev[0].elapsed_time(ev[1]),
                "dispatch forward": ev[1].elapsed_time(ev[2]),
                "experts forward": ev[2].elapsed_time(ev[3]),
                "combine forward": ev[3].elapsed_time(ev[4]),
                "combine backward": ev[4].elapsed_time(ev[5]),
                "experts backward": ev[5].elapsed_time(ev[6]),
                "dispatch backward": ev[6].elapsed_time(ev[7]),
                "route backward": ev[7].elapsed_time(ev[8])}

    one()
    for _ in range(5):
        for name, t in one().items():
            times[name].append(t)
    med = {name: statistics.median(t) for name, t in times.items()}
    experts = med["experts forward"] + med["experts backward"]
    around = sum(v for name, v in med.items() if not name.startswith("experts"))
    flop = 3 * 2 * e * cap * d * cfg.d_ff
    print(f"moe block {cfg.name} ({n} tokens, top-{k}, {e} experts x {cap} slots): "
          + ", ".join(f"{name} {v:.3f} ms" for name, v in med.items()), flush=True)
    print(f"moe block {cfg.name}: expert GEMMs {experts:.3f} ms forward+backward "
          f"({3 * flop / experts / 1e9:.1f} TFLOP/s on {3 * flop / 1e12:.2f} TFLOP); routing, "
          f"dispatch and combine {around:.3f} ms ({100 * around / (around + experts):.1f} % of "
          f"the block)", flush=True)
    del pp, xf
    torch.cuda.empty_cache()


def moe_family_phase(torch, ops, checks, device):
    """Phase 17: the moe family's paths through the user entry point at
    published width, with every check of ``train_phase``; routing on the
    card against the CPU at full width; card against CPU losses; the MoE
    block's time split. Returns the paths' launch counts and bf16-variant
    counts, their histories and peaks."""
    from repro_torch.configs.base import get_arch

    launches, bf16 = collections.Counter(), collections.Counter()
    histories, peaks = {}, {}
    for label, arch, layers, opt, lr, route in MOE_PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=layers, steps=4, opt=opt,
            comp="intsgd", wire="packed8", lr=lr, arch=arch, seq=MOE_SEQ, **route)
        launches.update(counts)
        bf16.update(ops.bf16_launch_counts())
        checks.true(f"{label}: peak {peaks[label]:.1f} GiB below the card's 80 GB",
                    peaks[label] * 2**30 < CARD_BYTES)
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for _, arch, *_ in MOE_PATHS:
        cfg = dataclasses.replace(get_arch(arch), n_layers=1)
        p, x = moe_layer_inputs(torch, cfg, device)
        routing_check(torch, checks, cfg, p, x)
        if arch == "mixtral-8x22b":
            moe_block_split(torch, cfg, p, x)
        del p, x
        torch.cuda.empty_cache()
    print(f"routing and block split: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    card_cpu_losses(torch, checks, device, [arch for _, arch, *_ in MOE_PATHS])
    print(f"moe card-cpu: {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, bf16, histories, peaks


# phase 18: the hybrid family at published width, 4 workers, 4 steps, IntSGD
# on packed8, seq 2048: (label, config, layers, optimizer, lr, route). 18
# layers are two blocks of attn_every 9, so the shared attention block's
# gradient sums over two applications (999,699,680 params).
HYBRID_PATHS = (
    ("zamba2-fused-sgd", "zamba2-2.7b", 18, "sgd", 0.3, FUSED_BF16),
    ("zamba2-zero1-adamw", "zamba2-2.7b", 18, "adamw", 3e-4, dict(fused=False)),
)
HYBRID_SEQ = 2048
HYBRID_LARGEST_LEAF = 18 * 2560 * 10240  # layers/m/w_xz at 18 layers: 471,859,200
HYBRID_CPU_LAYERS, HYBRID_CPU_SEQ = 9, 512  # one block; two SSD chunks of 256


def card_cpu_f32(torch, checks, device, arch, layers, seq) -> None:
    """``arch`` at ``layers`` layers, batch 1, seq ``seq``: the loss from
    the same float32 params, in float32 activations (TF32 off), on the card
    against the CPU's plain path, within 1e-3 relative; and the final
    hidden states, whose largest difference is printed beside their
    largest |value| and held to 1e-3 of it (the loss of a random-init model
    sits near log(vocab), where the two may round to the same float)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.inputs import materialize_batch
    from repro_torch.models.transformer import init_lm_params, lm_forward, lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device)
    batch = materialize_batch(cfg, ShapeConfig("card-cpu", seq, 1, "train"),
                              torch.Generator(device=device).manual_seed(1), device)
    f32 = dict(dtype=torch.float32)
    with torch.no_grad():
        card = lm_loss(params, batch, cfg, **f32).item()
        h_card = lm_forward(params, batch, cfg, **f32).cpu()
        params = {k: v.cpu() for k, v in params.items()}
        batch = {k: v.cpu() for k, v in batch.items()}
        t0 = time.perf_counter()
        cpu = lm_loss(params, batch, cfg, **f32).item()
        h_cpu = lm_forward(params, batch, cfg, **f32)
        cpu_s = time.perf_counter() - t0
    del params, batch
    gap = abs(card - cpu) / abs(cpu)
    checks.true(f"card-cpu {arch} ({layers} layers, seq {seq}, "
                f"float32): loss on the card {card!r}, on the CPU {cpu!r}, relative gap "
                f"{gap:.3g} < 1e-3", math.isfinite(card) and gap < 1e-3)
    dh, hmax = (h_card - h_cpu).abs().max().item(), h_cpu.abs().max().item()
    checks.true(f"card-cpu {arch}: final hidden states differ by at most {dh:.3g} "
                f"(largest |h| {hmax:.3g}), < 1e-3 of it", dh < 1e-3 * hmax)
    print(f"card-cpu {arch}: the CPU forward took {cpu_s:.1f}s", flush=True)
    torch.cuda.empty_cache()


def stage_times(torch, stages, env, out_name, grad_out, reps=5) -> dict:
    """Forward and backward ms of each stage of a chain, CUDA events between
    stages, median of ``reps`` runs after a warm-up. ``stages``: (label,
    fn, input names, output names) in order; ``env``: the named tensors the
    chain starts from. Each stage takes its inputs as fresh leaves, so its
    backward runs alone: the stages' backwards run in reverse, each from
    the gradients its outputs gathered from the later stages."""
    def one():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * len(stages) + 1)]
        vals, saved = dict(env), []
        ev[0].record()
        for i, (_, fn, ins, outs) in enumerate(stages):
            args = [vals[n].detach().requires_grad_(vals[n].is_floating_point()) for n in ins]
            res = fn(*args)
            vals.update(zip(outs, res))
            saved.append((args, res))
            ev[i + 1].record()
        grads = {out_name: grad_out}
        for j, ((_, _, ins, outs), (args, res)) in enumerate(zip(reversed(stages),
                                                                 reversed(saved))):
            pairs = [(r, grads[n]) for n, r in zip(outs, res) if n in grads]
            gs = torch.autograd.grad([r for r, _ in pairs], args, [g for _, g in pairs],
                                     allow_unused=True)
            for n, g in zip(ins, gs):
                if g is not None:
                    grads[n] = grads[n] + g if n in grads else g
            ev[len(stages) + 1 + j].record()
        ev[-1].synchronize()
        n = len(stages)
        out = {}
        for i, (label, *_) in enumerate(stages):
            out[f"{label} forward"] = ev[i].elapsed_time(ev[i + 1])
            out[f"{label} backward"] = ev[2 * n - i - 1].elapsed_time(ev[2 * n - i])
        return out

    one()
    times = collections.defaultdict(list)
    for _ in range(reps):
        for name, t in one().items():
            times[name].append(t)
    return {name: statistics.median(t) for name, t in times.items()}


def fwd_bwd_ms(torch, fn, args, grad_out, reps=5):
    """(device ms, host ms) of fn(*args) forward and backward: CUDA events
    around both, and the host's clock until the last launch is enqueued
    (before the device sync); medians of ``reps`` after a warm-up. A host
    time at or above the device time means the card waits on the host."""
    dev_ms, host_ms = [], []
    for i in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = fn(*args)
        torch.autograd.grad(out, args, grad_out)
        ev[1].record()
        t1 = time.perf_counter()
        ev[1].synchronize()
        if i:
            dev_ms.append(ev[0].elapsed_time(ev[1]))
            host_ms.append((t1 - t0) * 1e3)
    return statistics.median(dev_ms), statistics.median(host_ms)


def hybrid_layer_split(torch, device) -> None:
    """Where one zamba2 Mamba2 layer's time goes (published width, bf16
    params and activations, one worker's 2,048 tokens): each stage forward
    and backward (input projections, conv, SSD intra, states and inter,
    gate and norm, out-projection), then the whole layer as the train
    path runs it (the SSD under checkpoint, recomputed in backward) and the
    shared attention block, each with the host's enqueue time beside the
    device time. Printed."""
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.base import get_arch
    from repro_torch.models import ssm
    from repro_torch.models.common import SINGLE

    cfg = dataclasses.replace(get_arch("zamba2-2.7b"), n_layers=HYBRID_CPU_LAYERS)
    params = transformer.init_lm_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.bfloat16)
    p = {k[len("layers/m/"):]: v[0, 0].detach().requires_grad_(True)
         for k, v in params.items() if k.startswith("layers/m/")}
    shared = {k[len("shared_attn/"):]: v.detach().requires_grad_(True)
              for k, v in params.items() if k.startswith("shared_attn/")}
    del params
    gen = torch.Generator(device=device).manual_seed(5)
    b, t, d = 1, HYBRID_SEQ, cfg.d_model
    h, q, hd, n = transformer._ssm_heads(cfg), 256, transformer.SSM_HEAD_DIM, cfg.ssm_state
    x = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16).requires_grad_(True)
    grad_out = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
    chunks = lambda v: v.reshape(b, t // q, q, *v.shape[2:])
    h0 = torch.zeros(b, h, n, hd, device=device)

    def intra(xh, dt, bc, a_log):
        return ssm.ssd_intra(chunks(xh), chunks(dt), chunks(bc), -torch.exp(a_log.float()))

    def inter(bc, s, h_in, y_intra):
        return ((y_intra + ssm.ssd_inter(chunks(bc), s, h_in)).reshape(b, t, h, hd),)

    stages = (
        ("input projections",
         lambda x, w_xz, w_bc, w_dt, dt_bias: ssm.in_proj(
             dict(w_xz=w_xz, w_bc=w_bc, w_dt=w_dt, dt_bias=dt_bias), x),
         ("x", "w_xz", "w_bc", "w_dt", "dt_bias"), ("xin", "z", "bc", "dt")),
        ("conv", lambda xin, conv_w: (
            ssm._causal_conv(xin, conv_w).reshape(b, t, h, hd).float(),),
         ("xin", "conv_w"), ("xh",)),
        ("ssd intra", intra, ("xh", "dt", "bc", "a_log"), ("s", "y_intra")),
        ("ssd states", lambda xh, dt, bc, s: (
            ssm.ssd_states(chunks(xh), chunks(dt), chunks(bc), s, h0)[0],),
         ("xh", "dt", "bc", "s"), ("h_in",)),
        ("ssd inter", inter, ("bc", "s", "h_in", "y_intra"), ("y",)),
        ("gate and norm", lambda y, xh, z, d_skip, norm_w: (
            ssm.gate_norm(dict(d_skip=d_skip, norm_w=norm_w), y, xh, z),),
         ("y", "xh", "z", "d_skip", "norm_w"), ("yn",)),
        ("out-projection", lambda yn, w_out: (yn @ w_out,), ("yn", "w_out"), ("out",)),
    )
    med = stage_times(torch, stages, dict(p, x=x), "out", grad_out)
    total = sum(med.values())
    ssd = sum(v for k, v in med.items() if k.startswith("ssd"))
    print(f"mamba2 layer zamba2-2.7b ({t} tokens, {h} heads of {hd}, state {n}, chunks of "
          f"{q}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items()), flush=True)
    print(f"mamba2 layer: stages {total:.3f} ms forward+backward, of which the SSD "
          f"{ssd:.3f} ms ({100 * ssd / total:.1f} %)", flush=True)
    kw = dict(n_heads=h, head_dim=hd, d_state=n)
    layer = lambda x, *_: ssm.mamba2_train(p, x, **kw)
    dev_ms, host_ms = fwd_bwd_ms(torch, layer, [x, *p.values()], grad_out)
    waits = ": the card waits on the host" if host_ms >= 0.9 * dev_ms else ""
    print(f"mamba2 layer as trained (SSD recomputed in backward): device {dev_ms:.3f} ms, "
          f"host enqueue {host_ms:.3f} ms forward+backward (host/device "
          f"{host_ms / dev_ms:.2f}{waits})", flush=True)
    emb = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
    pos = torch.arange(t, device=device).expand(b, t)
    dims = transformer.resolve_dims(cfg)
    block = lambda hh, *_: transformer._shared_attn_block(shared, hh, emb, pos, cfg, dims,
                                                          SINGLE)
    dev_ms, host_ms = fwd_bwd_ms(torch, block, [x, *shared.values()], grad_out)
    print(f"shared attention block: device {dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms "
          f"forward+backward", flush=True)
    del p, shared, x
    torch.cuda.empty_cache()


def hybrid_family_phase(torch, ops, checks, timings, device):
    """Phase 18: zamba2's paths through the user entry point at published
    width, with every check of ``train_phase``; card against CPU; one
    Mamba2 layer and the shared block timed by stage; the kernels at the
    hybrid's largest leaf. Returns the paths' launch counts and
    bf16-variant counts, their histories and peaks."""
    launches, bf16 = collections.Counter(), collections.Counter()
    histories, peaks = {}, {}
    for label, arch, layers, opt, lr, route in HYBRID_PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=layers, steps=4, opt=opt,
            comp="intsgd", wire="packed8", lr=lr, arch=arch, seq=HYBRID_SEQ, **route)
        launches.update(counts)
        bf16.update(ops.bf16_launch_counts())
        checks.true(f"{label}: peak {peaks[label]:.1f} GiB below the card's 80 GB",
                    peaks[label] * 2**30 < CARD_BYTES)
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    hybrid_layer_split(torch, device)
    print(f"mamba2 layer split: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    card_cpu_f32(torch, checks, device, "zamba2-2.7b", HYBRID_CPU_LAYERS, HYBRID_CPU_SEQ)
    print(f"hybrid card-cpu: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    largest_leaf_kernels(torch, ops, checks, timings, device, d=HYBRID_LARGEST_LEAF)
    print(f"kernels at the hybrid's largest leaf: {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, bf16, histories, peaks


# phase 19: the xLSTM family at published width, 4 workers, 4 steps, IntSGD
# on packed8, seq 2048: (label, config, layers, optimizer, lr, route). Its 12
# layers cut to 6 for the script's time (a fused step took 5.7-7.3 s at 12):
# two (mLSTM, mLSTM, sLSTM) blocks, 55,189,280 params in the same 24 leaves
# (stacked by block), the embedding tied to the head; phases 22 and 25 decode
# it at its full 12.
XLSTM_PATHS = (
    ("xlstm-fused-sgd", "xlstm-125m", 6, "sgd", 0.3, FUSED_BF16),
    ("xlstm-zero1-adamw", "xlstm-125m", 6, "adamw", 3e-4, dict(fused=False)),
)
XLSTM_SEQ = 2048
XLSTM_LEAVES = 24
XLSTM_CPU_LAYERS, XLSTM_CPU_SEQ = 6, 512  # two mLSTM chunks, 512 sLSTM steps


def slstm_loop_check(torch, checks, zx, r_h, n_heads, dh, grad_out) -> None:
    """The port's time loop (``slstm_scan``, its backward written by hand)
    on the card against ``slstm_scan_reference`` (each step through
    autograd) at full width, float32 (zx, r_h): hidden states and gradients
    within 1e-4 of their largest |value|; then both timed in turns (port,
    autograd, autograd, port). Printed."""
    from repro_torch.models import xlstm

    fns = {"port": lambda z, r: xlstm.slstm_scan(z, r, n_heads, dh),
           "autograd": lambda z, r: xlstm.slstm_scan_reference(z, r, n_heads, dh)}
    outs = []
    for fn in fns.values():
        y = fn(zx, r_h)
        outs.append([y.detach(), *torch.autograd.grad(y, [zx, r_h], grad_out)])
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*outs)]
    checks.true(f"slstm time loop: the hand-written backward against autograd's on the card, "
                f"largest differences {[f'{e:.3g}' for e in errs]} of the largest |h|, |dzx|, "
                f"|dr_h| (< 1e-4)", all(e < 1e-4 for e in errs))
    times = collections.defaultdict(list)
    for name in ("port", "autograd", "autograd", "port"):
        times[name].append(fwd_bwd_ms(torch, fns[name], [zx, r_h], grad_out, reps=1)[0])
    t = zx.shape[1]
    print("slstm time loop in turns, device ms forward+backward: " + ", ".join(
        f"{k} {v} ({1e3 * min(v) / t:.1f} us a time step)" for k, v in times.items()),
        flush=True)


def xlstm_layer_split(torch, checks, device) -> float:
    """Where one mLSTM and one sLSTM layer of xlstm-125m spend their time
    (published width, bf16 params and activations, one worker's 2,048
    tokens): each stage forward and backward (mLSTM: projections, intra,
    the chunk carry, inter, norm and out-projection; sLSTM: projection, the
    time loop, norm and out-projection), then each layer as trained and the
    sLSTM's time loop alone, with the host's enqueue time beside the device
    time, and the time loop against its autograd reference
    (:func:`slstm_loop_check`). Printed; returns the time loop's device ms
    forward and backward (alone, median of 5)."""
    import repro_torch.models.transformer as transformer
    from repro_torch.configs.base import get_arch
    from repro_torch.models import xlstm

    cfg = dataclasses.replace(get_arch("xlstm-125m"), n_layers=3)
    params = transformer.init_lm_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.bfloat16)
    cells = {c: {k[len(f"layers/{c}/cell/"):]: v[0].detach().requires_grad_(True)
                 for k, v in params.items() if k.startswith(f"layers/{c}/cell/")}
             for c in ("m1", "s")}
    del params
    gen = torch.Generator(device=device).manual_seed(5)
    b, t, d = 1, XLSTM_SEQ, cfg.d_model
    h, dh, q = cfg.n_heads, cfg.head_dim, min(256, t)
    dk = h * dh
    x = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16).requires_grad_(True)
    grad_out = torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
    chunks = lambda v: v.reshape(b, t // q, q, *v.shape[2:])
    c0 = torch.zeros(b, h, dh, dh, device=device)
    n0 = torch.zeros(b, h, dh, device=device)
    out = lambda y, norm_w, w_out: (xlstm.out_proj(dict(norm_w=norm_w, w_out=w_out), y,
                                                   torch.bfloat16),)
    m_stages = (
        ("projections", lambda x, w_q, w_k, w_v, w_if, if_bias: tuple(
            chunks(a) for a in xlstm.mlstm_proj(
                dict(w_q=w_q, w_k=w_k, w_v=w_v, w_if=w_if, if_bias=if_bias), x, h, dh)),
         ("x", "w_q", "w_k", "w_v", "w_if", "if_bias"), ("q", "k", "v", "logi", "logf")),
        ("intra", xlstm.mlstm_intra, ("q", "k", "v", "logf", "logi"),
         ("s", "y_intra", "n_intra")),
        ("carry", lambda k, v, logi, s: xlstm.mlstm_states(k, v, logi, s, c0, n0),
         ("k", "v", "logi", "s"), ("c_in", "n_in")),
        ("inter", lambda q, s, y_intra, n_intra, c_in, n_in: (
            xlstm.mlstm_inter(q, s, y_intra, n_intra, c_in, n_in).reshape(b, t, dk),),
         ("q", "s", "y_intra", "n_intra", "c_in", "n_in"), ("y",)),
        ("norm and out-projection", out, ("y", "norm_w", "w_out"), ("out",)),
    )
    s_stages = (
        ("projection", lambda x, w_in, bias: (xlstm.slstm_proj(dict(w_in=w_in, b=bias), x),),
         ("x", "w_in", "b"), ("zx",)),
        ("time loop", lambda zx, r_h: (xlstm.slstm_scan(zx, r_h, h, dh),), ("zx", "r_h"),
         ("y",)),
        ("norm and out-projection", out, ("y", "norm_w", "w_out"), ("out",)),
    )
    kw = dict(n_heads=h, head_dim=dh)
    loop_ms = None
    for name, cell, stages, fn in (
            ("mlstm", cells["m1"], m_stages, xlstm.mlstm_train),
            ("slstm", cells["s"], s_stages, xlstm.slstm_train)):
        med = stage_times(torch, stages, dict(cell, x=x), "out", grad_out, reps=3)
        total = sum(med.values())
        print(f"{name} layer xlstm-125m ({t} tokens, {h} heads of {dh}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
              + f"; stages {total:.3f} ms forward+backward", flush=True)
        layer = lambda x, *_: fn(cell, x, **kw)
        dev_ms, host_ms = fwd_bwd_ms(torch, layer, [x, *cell.values()], grad_out, reps=3)
        waits = ": the card waits on the host" if host_ms >= 0.9 * dev_ms else ""
        print(f"{name} layer as trained: device {dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms "
              f"forward+backward (host/device {host_ms / dev_ms:.2f}{waits})", flush=True)
        if name == "slstm":
            zx = xlstm.slstm_proj(cell, x.detach()).requires_grad_(True)
            scan = lambda zx, r_h: xlstm.slstm_scan(zx, r_h, h, dh)
            grad_hs = torch.randn(b, t, dk, generator=gen, device=device)
            loop_ms, host_ms = fwd_bwd_ms(torch, scan, [zx, cell["r_h"]], grad_hs)
            print(f"slstm time loop alone: device {loop_ms:.3f} ms, host enqueue {host_ms:.3f} ms "
                  f"forward+backward (host/device {host_ms / loop_ms:.2f}); "
                  f"{1e3 * loop_ms / t:.1f} us a time step on the card, "
                  f"{1e3 * host_ms / t:.1f} us on the host", flush=True)
            r32 = cell["r_h"].detach().float().requires_grad_(True)
            slstm_loop_check(torch, checks, zx, r32, h, dh, grad_hs)
    del cells, x
    torch.cuda.empty_cache()
    return loop_ms


def xlstm_family_phase(torch, ops, checks, device):
    """Phase 19: xlstm-125m's paths through the user entry point at
    published width and full depth, with every check of ``train_phase``;
    one mLSTM and one sLSTM layer timed by stage; card against CPU.
    Returns the paths' launch counts and bf16-variant counts, their
    histories and peaks."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import param_shapes

    shapes = param_shapes(get_arch("xlstm-125m"))
    size = sum(math.prod(v) for v in shapes.values())
    checks.true(f"xlstm-125m: {len(shapes)} leaves (expected {XLSTM_LEAVES}), {size} params, "
                f"no lm_head (tied embeddings)",
                len(shapes) == XLSTM_LEAVES and "lm_head" not in shapes)
    launches, bf16 = collections.Counter(), collections.Counter()
    histories, peaks = {}, {}
    for label, arch, layers, opt, lr, route in XLSTM_PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=layers, steps=4, opt=opt,
            comp="intsgd", wire="packed8", lr=lr, arch=arch, seq=XLSTM_SEQ, **route)
        launches.update(counts)
        bf16.update(ops.bf16_launch_counts())
        checks.true(f"{label}: peak {peaks[label]:.1f} GiB below the card's 80 GB",
                    peaks[label] * 2**30 < CARD_BYTES)
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    loop_ms = xlstm_layer_split(torch, checks, device)
    n_slstm = XLSTM_PATHS[0][2] // 3 * N_WORKERS
    for label in histories:
        step = compressed_ms(histories[label])
        print(f"{label}: the sLSTM time loops, {n_slstm} a step ({N_WORKERS} workers x "
              f"{n_slstm // N_WORKERS} layers) at {loop_ms:.1f} ms each: {n_slstm * loop_ms:.1f} "
              f"ms, {100 * n_slstm * loop_ms / step:.1f} % of the {step:.1f} ms step", flush=True)
    print(f"xlstm layer split: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    card_cpu_f32(torch, checks, device, "xlstm-125m", XLSTM_CPU_LAYERS, XLSTM_CPU_SEQ)
    print(f"xlstm card-cpu: {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, bf16, histories, peaks


# phase 20: the encdec family at published width and full depth, 4 workers,
# 4 steps, IntSGD on packed8, seq 2048 (2,048 frames of 160 and 2,048 target
# tokens a worker): (label, optimizer, lr, route). 12 encoder and 12 decoder
# layers, 877,445,120 params in 37 leaves; embed and lm_head 262,354,944
# elements each.
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_PATHS = (
    ("seamless-fused-sgd", "sgd", 0.3, FUSED_BF16),
    ("seamless-zero1-adamw", "adamw", 3e-4, dict(fused=False)),
)
ENCDEC_SEQ = 2048
ENCDEC_LEAVES, ENCDEC_PARAMS = 37, 877_445_120
ENCDEC_CPU_LAYERS, ENCDEC_CPU_SEQ = 2, 256  # 2 encoder + 2 decoder layers


def encdec_card_cpu_f32(torch, checks, device, layers=ENCDEC_CPU_LAYERS,
                        seq=ENCDEC_CPU_SEQ) -> None:
    """seamless-m4t-medium at ``layers`` encoder and decoder layers, batch
    1, seq ``seq``: the loss from the same float32 params and batch, in
    float32 activations (TF32 off), on the card against the CPU's plain
    path within 1e-3 relative; the encoder states within 1e-4 of their
    largest |h|, the decoder's final states within 1e-3 of theirs."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch.inputs import materialize_batch
    from repro_torch.models import encdec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(ENCDEC_ARCH), enc_layers=layers, dec_layers=layers)
    params = encdec.init_encdec_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0), device=device)
    batch = materialize_batch(cfg, ShapeConfig("card-cpu", seq, 1, "train"),
                              torch.Generator(device=device).manual_seed(1), device)
    f32 = dict(dtype=torch.float32)
    out = {}
    for where in ("card", "cpu"):
        if where == "cpu":
            params = {k: v.cpu() for k, v in params.items()}
            batch = {k: v.cpu() for k, v in batch.items()}
        t0 = time.perf_counter()
        with torch.no_grad():
            enc = encdec.encode(params, batch["frames"], cfg, **f32)
            dec = encdec.decode_states(params, enc, batch["tokens"], cfg, **f32)
            loss = encdec.encdec_loss(params, batch, cfg, **f32).item()
        out[where] = (loss, enc.cpu(), dec.cpu(), time.perf_counter() - t0)
    del params, batch
    (card, e_card, d_card, _), (cpu, e_cpu, d_cpu, cpu_s) = out["card"], out["cpu"]
    gap = abs(card - cpu) / abs(cpu)
    checks.true(f"card-cpu {ENCDEC_ARCH} ({layers} + {layers} layers, seq {seq}, float32): "
                f"loss on the card {card!r}, on the CPU {cpu!r}, relative gap {gap:.3g} < 1e-3",
                math.isfinite(card) and gap < 1e-3)
    for name, a, b, tol in (("encoder", e_card, e_cpu, 1e-4), ("decoder", d_card, d_cpu, 1e-3)):
        dh, hmax = (a - b).abs().max().item(), b.abs().max().item()
        checks.true(f"card-cpu {ENCDEC_ARCH}: {name} states differ by at most {dh:.3g} "
                    f"(largest |h| {hmax:.3g}), < {tol:g} of it", dh < tol * hmax)
    print(f"card-cpu {ENCDEC_ARCH}: the CPU forwards took {cpu_s:.1f}s", flush=True)
    torch.cuda.empty_cache()


def encdec_layer_split(torch, device) -> None:
    """Where one seamless-m4t-medium encoder layer and one decoder layer
    spend their time (published width, bf16 params and activations, one
    worker's 2,048 frames and 2,048 tokens): each stage forward and backward
    with CUDA events (LayerNorm, QKV and RoPE, bidirectional or causal
    attention, out-projection; the decoder's cross attention K/V projection
    and its attention; the GELU MLP), the logits (2,048 x 1,024 -> 256,206)
    and the loss, then each layer as trained with the host's enqueue time
    beside the device time. Printed."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.attention import gqa_attend
    from repro_torch.models.common import cross_entropy, layernorm, rope
    from repro_torch.models.mlp import gelu_mlp

    cfg = dataclasses.replace(get_arch(ENCDEC_ARCH), enc_layers=1, dec_layers=1)
    params = encdec.init_encdec_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0), device=device,
        dtype=torch.bfloat16)
    layer = lambda stack: {k[len(stack) + 1:]: v[0].detach().requires_grad_(True)
                           for k, v in params.items() if k.startswith(stack + "/")}
    enc, dec = layer("enc_layers"), layer("dec_layers")
    head = params["lm_head"].detach().requires_grad_(True)
    del params
    gen = torch.Generator(device=device).manual_seed(5)
    b, t, d, dh = 1, ENCDEC_SEQ, cfg.d_model, cfg.head_dim
    rand = lambda: torch.randn(b, t, d, generator=gen, device=device).to(torch.bfloat16)
    x, enc_out, grad_out = rand().requires_grad_(True), rand().requires_grad_(True), rand()
    pos = torch.arange(t, device=device).expand(b, t)
    heads = lambda y: y.reshape(b, t, -1, dh)
    ln = lambda z, w, bias: (layernorm(z, w, bias),)
    qkv = lambda z, wq, wk, wv: (rope(heads(z @ wq), pos), rope(heads(z @ wk), pos),
                                 heads(z @ wv))
    attend = lambda causal: lambda q, k, v: (gqa_attend(q, k, v, causal=causal),)
    residual = lambda a, wo, h: (h + a @ wo,)
    mlp = lambda z, w_in, b_in, w_out, b_out, h: (
        h + gelu_mlp(dict(w_in=w_in, b_in=b_in, w_out=w_out, b_out=b_out), z),)
    mlp_in = ("mlp/w_in", "mlp/b_in", "mlp/w_out", "mlp/b_out")
    enc_stages = (
        ("layernorm", ln, ("x", "ln1/w", "ln1/b"), ("z",)),
        ("qkv and rope", qkv, ("z", "attn/wq", "attn/wk", "attn/wv"), ("q", "k", "v")),
        ("bidirectional attention", attend(False), ("q", "k", "v"), ("a",)),
        ("out-projection", residual, ("a", "attn/wo", "x"), ("h",)),
        ("layernorm 2", ln, ("h", "ln2/w", "ln2/b"), ("z2",)),
        ("gelu mlp", mlp, ("z2", *mlp_in, "h"), ("out",)),
    )
    dec_stages = (
        ("layernorm", ln, ("x", "ln1/w", "ln1/b"), ("z",)),
        ("qkv and rope", qkv, ("z", "self_attn/wq", "self_attn/wk", "self_attn/wv"),
         ("q", "k", "v")),
        ("causal attention", attend(True), ("q", "k", "v"), ("a",)),
        ("out-projection", residual, ("a", "self_attn/wo", "x"), ("h",)),
        ("layernorm x", ln, ("h", "ln_x/w", "ln_x/b"), ("zx",)),
        ("cross k/v projection", lambda e, wk, wv: (heads(e @ wk), heads(e @ wv)),
         ("enc_out", "cross_attn/wk", "cross_attn/wv"), ("ck", "cv")),
        ("cross attention", lambda zx, wq, ck, cv: (
            gqa_attend(heads(zx @ wq), ck, cv, causal=False),),
         ("zx", "cross_attn/wq", "ck", "cv"), ("ca",)),
        ("cross out-projection", residual, ("ca", "cross_attn/wo", "h"), ("h2",)),
        ("layernorm 2", ln, ("h2", "ln2/w", "ln2/b"), ("z2",)),
        ("gelu mlp", mlp, ("z2", *mlp_in, "h2"), ("out",)),
    )
    labels = torch.randint(0, cfg.vocab, (b, t), generator=gen, device=device)
    head_stages = (
        ("logits", lambda hd, w: ((hd @ w).to(torch.float32),), ("hd", "lm_head"), ("logits",)),
        ("loss", lambda logits: (cross_entropy(logits, labels).mean(),), ("logits",),
         ("loss",)),
    )
    for name, stages, env, out_name, g in (
            ("encoder", enc_stages, dict(enc, x=x), "out", grad_out),
            ("decoder", dec_stages, dict(dec, x=x, enc_out=enc_out), "out", grad_out),
            ("head", head_stages, dict(hd=x, lm_head=head), "loss",
             torch.ones((), device=device))):
        med = stage_times(torch, stages, env, out_name, g, reps=3)
        total = sum(med.values())
        attn = sum(v for k, v in med.items() if "attention" in k)
        print(f"{name} {ENCDEC_ARCH} ({t} tokens, {cfg.n_heads} heads of {dh}): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
              + f"; stages {total:.3f} ms forward+backward"
              + (f", attention {attn:.3f} ms ({100 * attn / total:.1f} %)" if attn else ""),
              flush=True)
    for name, fn, args in (
            ("encoder", lambda x, *_: encdec.encoder_layer(enc, x, pos, cfg), [x, *enc.values()]),
            ("decoder", lambda x, e, *_: encdec.decoder_layer(dec, x, e, pos, cfg),
             [x, enc_out, *dec.values()])):
        dev_ms, host_ms = fwd_bwd_ms(torch, fn, args, grad_out, reps=3)
        waits = ": the card waits on the host" if host_ms >= 0.9 * dev_ms else ""
        print(f"{name} layer as trained: device {dev_ms:.3f} ms, host enqueue {host_ms:.3f} ms "
              f"forward+backward (host/device {host_ms / dev_ms:.2f}{waits})", flush=True)
    del enc, dec, head, x, enc_out
    torch.cuda.empty_cache()


def encdec_family_phase(torch, ops, checks, device):
    """Phase 20: seamless-m4t-medium's paths through the user entry points
    (``build_train_step`` and ``materialize_batch``, as ``VlmRun`` drives
    them) at published width and full depth, with every check of
    ``train_phase``; the two routes' exact-step losses against each other;
    the logits GEMMs at the vocabulary of 256,206 against an aligned one;
    one encoder and one decoder layer timed by stage; card against CPU.
    Returns the paths' launch counts and bf16-variant counts, their
    histories and peaks."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.encdec import param_shapes

    cfg = get_arch(ENCDEC_ARCH)
    shapes = param_shapes(cfg)
    size = sum(math.prod(v) for v in shapes.values())
    checks.true(f"{ENCDEC_ARCH}: {len(shapes)} leaves (expected {ENCDEC_LEAVES}), {size} params "
                f"(expected {ENCDEC_PARAMS}), lm_head untied",
                len(shapes) == ENCDEC_LEAVES and size == ENCDEC_PARAMS and "lm_head" in shapes)
    launches, bf16 = collections.Counter(), collections.Counter()
    histories, peaks = {}, {}
    for label, opt, lr, route in ENCDEC_PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=cfg.n_layers, steps=4, opt=opt,
            comp="intsgd", wire="packed8", lr=lr, arch=ENCDEC_ARCH, seq=ENCDEC_SEQ, **route)
        launches.update(counts)
        bf16.update(ops.bf16_launch_counts())
        encodes = ENCDEC_LEAVES * N_WORKERS * 3
        checks.true(f"{label}: {counts['int_compress']} encodes ({ENCDEC_LEAVES} leaves x "
                    f"{N_WORKERS} workers x 3 compressed steps = {encodes})",
                    counts["int_compress"] == encodes)
        checks.true(f"{label}: peak {peaks[label]:.1f} GiB below the card's 80 GB",
                    peaks[label] * 2**30 < CARD_BYTES)
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    # the exact step 0 runs the same weights (bf16 against float32) on the
    # same batch; after it the routes' optimizers differ (SGD, AdamW), so
    # their later losses are printed, not held
    (fused, f_hist), (zero1, z_hist) = histories.items()
    for i, (f, z) in enumerate(zip(f_hist, z_hist)):
        print(f"cross-route {ENCDEC_ARCH}: step {i}: {fused} loss {f['loss']!r}, {zero1} loss "
              f"{z['loss']!r}, relative gap {abs(f['loss'] - z['loss']) / abs(z['loss']):.3g}",
              flush=True)
    gap = abs(f_hist[0]["loss"] - z_hist[0]["loss"]) / abs(z_hist[0]["loss"])
    checks.true(f"cross-route {ENCDEC_ARCH}: step 0 losses within 1e-2 relative ({gap:.3g})",
                gap < 1e-2)
    vocab_probe(torch, device, vocab=cfg.vocab, d_model=cfg.d_model, tokens=ENCDEC_SEQ)
    t0 = time.perf_counter()
    encdec_layer_split(torch, device)
    print(f"encdec layer split: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    encdec_card_cpu_f32(torch, checks, device)
    print(f"encdec card-cpu: {time.perf_counter() - t0:.1f}s", flush=True)
    return launches, bf16, histories, peaks


# phase 21: the serve path and the runtime at published width
SERVE_ARCH, MLA_ARCH = "granite-8b", "deepseek-v2-lite-16b"
SERVE_SLOTS, SERVE_MAX_SEQ = 4, 128
SERVE_REQUESTS, SERVE_MAX_NEW = 6, 16
MLA_REQUESTS, MLA_MAX_NEW = 4, 8
REFRESH_ALPHA = 1000.0
CHECK_LAYERS = 2  # granite's and deepseek's float32 checks, card and CPU
TRAIN_DECODE_T, CARD_CPU_T = 32, 8
STRAGGLER_LAYERS = 4  # the main path's leaves
ELASTIC_SEQ = 512
REFRESH_CHUNK_WORDS = 1 << 26  # the plain check's words at a time


def host_card_ms(torch, fn, reps: int = 5):
    """Medians of ``fn``'s host enqueue time (host clock until it returns)
    and its card time (CUDA events around it), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    host, card = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        card.append(a.elapsed_time(b))
    return statistics.median(host), statistics.median(card)


def timed_steps(torch, eng) -> list:
    """Wrap ``eng.step`` so that each decode step ends in a sync and its
    host-clock ms is recorded in the returned list."""
    times, real = [], eng.step

    def step():
        t0 = time.perf_counter()
        out = real()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.step = step
    return times


def serve_requests(torch, eng, prompts, max_new):
    """Submit the prompts, run the engine with its steps timed; (requests,
    iterations, wall s, step ms)."""
    from repro_torch.serving.engine import Request

    steps = timed_steps(torch, eng)
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    try:
        iters = eng.run()
    finally:
        del eng.step  # the wrapper refers to the engine: no cycle outlives the run
    return reqs, iters, time.perf_counter() - t0, steps


def serve_checks(checks, label, reqs, vocab) -> None:
    checks.true(f"{label}: all {len(reqs)} requests done, every token in [0, {vocab})",
                all(r.done for r in reqs)
                and all(0 <= t < vocab for r in reqs for t in r.out))


def serve_granite(torch, ops, checks, device, counts):
    """granite-8b at full depth through ServeEngine, then the weight
    refresh over the integer wire on it."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import prompts
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.utils.tree import tree_size

    cfg = get_arch(SERVE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device, dtype=torch.bfloat16)
    n_params = tree_size(params)
    print(f"serve {SERVE_ARCH}: {cfg.n_layers} layers, {n_params} bf16 params, "
          f"{SERVE_SLOTS} slots, max_seq {SERVE_MAX_SEQ}", flush=True)
    ps = prompts(SERVE_REQUESTS, cfg.vocab)
    eng = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    reqs, iters, wall, steps = serve_requests(torch, eng, ps, SERVE_MAX_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(r.out) for r in reqs)
    host, card = host_card_ms(torch, lambda: ServeEngine.step(eng))
    print(f"serve {SERVE_ARCH}: {len(reqs)} requests, {iters} engine iterations "
          f"({wall / iters * 1e3:.2f} ms each on average), {len(steps)} decode steps (median "
          f"{statistics.median(steps):.2f} ms, min {min(steps):.2f}, max {max(steps):.2f}; each "
          f"synchronized), {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), peak "
          f"{peak:.2f} GiB; one step: host enqueue {host:.2f} ms, card {card:.2f} ms, host over "
          f"card {host / card:.2f}", flush=True)
    serve_checks(checks, f"serve {SERVE_ARCH}", reqs, cfg.vocab)
    outs = []
    for companion in (False, True):
        e = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
        r = Request(rid=0, prompt=list(ps[0]), max_new=SERVE_MAX_NEW)
        e.submit(r)
        if companion:
            e.submit(Request(rid=1, prompt=list(ps[1]), max_new=SERVE_MAX_NEW))
        e.run()
        outs.append(r.out)
        del e
    checks.true(f"serve {SERVE_ARCH}: request 0's {len(outs[0])} tokens the same alone and "
                f"beside a companion (and {'the same' if outs[0] == reqs[0].out else 'not'} "
                "as among 6)", outs[0] == outs[1])
    refresh_full(torch, ops, checks, device, eng, params, counts)
    del eng, params
    torch.cuda.empty_cache()


def refresh_words(torch, device, params, alpha, gen, keep=False):
    """The trainer side: each leaf's Δ = 1e-3·N(0, 1), encoded at α for
    n = 1 and packed8, one leaf at a time (Δ freed before the next unless
    ``keep``); returns the codec, the words and the kept Δs."""
    from repro_torch.wire import PackedInt

    wf = PackedInt(bits=8)
    words, deltas = {}, {}
    seeds = torch.randint(-(2**31), 2**31, (len(params),), generator=torch.Generator()
                          .manual_seed(11), dtype=torch.int64).to(torch.int32).to(device)
    for i, (k, p) in enumerate(params.items()):
        delta = torch.randn(p.shape, generator=gen, device=device).mul_(1e-3)
        ints = wf.encode(delta, alpha, seeds[i], n_workers=1)
        words[k] = wf.pack(ints, n_workers=1)
        if keep:
            deltas[k] = delta
        del ints, delta
    return wf, words, deltas


def refresh_equal_plain(torch, ops, old, words, new, alpha) -> bool:
    """``new`` == (old.float() + unpack_plain(words) / (1·α)).to(old's
    type), bit for bit, the plain unpack taken ``REFRESH_CHUNK_WORDS`` words
    at a time (word w holds elements j·m + w, j < 4)."""
    k, m, d = 4, words.numel(), old.numel()
    of, nf = old.reshape(-1), new.reshape(-1)
    for w0 in range(0, m, REFRESH_CHUNK_WORDS):
        c = min(m, w0 + REFRESH_CHUNK_WORDS) - w0
        ints = ops.unpack_words.plain(words[w0:w0 + c], (k * c,), bits=8, n_summed=1)
        for j in range(k):
            lo, hi = j * m + w0, min(j * m + w0 + c, d)
            if hi <= lo:
                continue
            delta = ints[j * c:j * c + hi - lo].to(torch.float32) / (1 * alpha)
            if not torch.equal(nf[lo:hi], (of[lo:hi].float() + delta).to(old.dtype)):
                return False
    return True


def refresh_full(torch, ops, checks, device, eng, params, counts, label=SERVE_ARCH,
                 held=None) -> None:
    """The weight refresh on the full-depth engine of ``label``: trainer
    side (encode and pack, counted), engine side (apply_wire_delta,
    counted), the new params of the leaves ``held`` (every leaf if None)
    against the plain path on the same words."""
    alpha = torch.tensor(REFRESH_ALPHA, device=device)
    n_leaves = len(params)
    largest = max(p.numel() for p in params.values())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wf, words, _ = refresh_words(torch, device, params, alpha,
                                 torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    t_trainer = time.perf_counter() - t0
    trainer = ops.launch_counts()
    counts.update(trainer)
    nbytes = sum(w.numel() * w.element_size() for w in words.values())
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.apply_wire_delta(words, alpha, wf)
    torch.cuda.synchronize()
    t_apply = time.perf_counter() - t0
    engine = ops.launch_counts()
    counts.update(engine)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"refresh {label}: {n_leaves} leaves (largest {largest} elements), wire "
          f"{nbytes} bytes of packed8 words (float32: {4 * sum(p.numel() for p in params.values())}"
          f"); trainer side {t_trainer:.3f} s, apply_wire_delta {t_apply * 1e3:.1f} ms, peak "
          f"{peak:.2f} GiB; launches trainer {trainer}, engine {engine}", flush=True)
    want_t = {k.name: 0 for k in ops.KERNELS}
    want_e = dict(want_t)
    want_t.update(int_compress=n_leaves, pack_words=n_leaves)
    want_e.update(unpack_words=n_leaves)
    checks.true(f"refresh {label}: launches {trainer} then {engine} (expected one "
                "int_compress and one pack_words a leaf, then one unpack_words a leaf)",
                trainer == want_t and engine == want_e)
    held = list(params) if held is None else held
    same = all(eng.params[k].dtype == params[k].dtype and refresh_equal_plain(
        torch, ops, params[k], words[k], eng.params[k], alpha) for k in held)
    which = "every new param" if len(held) == n_leaves else f"new {', '.join(held)}"
    checks.true(f"refresh {label}: {which} bit-equal to the plain path on the same words",
                same)
    # the same words applied once more, the allocator's segments now mapped
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.apply_wire_delta(words, alpha, wf)
    torch.cuda.synchronize()
    print(f"refresh {label}: apply_wire_delta again {(time.perf_counter() - t0) * 1e3:.1f} "
          "ms (the memory already mapped)", flush=True)
    counts.update(ops.launch_counts())


def f32_checks(torch, ops, checks, device, counts) -> None:
    """granite's width at CHECK_LAYERS layers, float32: train == decode,
    card against CPU, the refresh within 1/α."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.decode import init_lm_cache, lm_decode_step
    from repro_torch.models.transformer import init_lm_params, lm_forward, lm_logits
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=CHECK_LAYERS)
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(1),
                            device=device)
    tokens = torch.randint(0, cfg.vocab, (1, TRAIN_DECODE_T),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = lm_logits(params, lm_forward(params, {"tokens": tokens.to(device)}, cfg,
                                            torch.float32), cfg)[0]
        runs = []  # the card's, then the CPU's
        for i, dev in enumerate((device, torch.device("cpu"))):
            p = {k: v.to(dev) for k, v in params.items()}
            cache = init_lm_cache(cfg, 1, TRAIN_DECODE_T, device=dev, dtype=torch.float32)
            got = []
            for t in range(CARD_CPU_T if i else TRAIN_DECODE_T):
                logits, cache = lm_decode_step(p, cache, tokens[:, t].to(dev),
                                               torch.full((1,), t, device=dev), cfg,
                                               dtype=torch.float32)
                got.append(logits[0].cpu())
            runs.append((torch.stack(got), {k: v.cpu() for k, v in cache.items()}))
            del p, cache
    (decode, cache_g), (cpu, cache_c) = runs
    err = (decode - want.cpu()).abs().max().item() / want.abs().max().item()
    checks.true(f"train == decode ({SERVE_ARCH}, {CHECK_LAYERS} layers, float32, "
                f"{TRAIN_DECODE_T} tokens): logits within 1e-4 of the largest |logit| "
                f"({err:.3g})", err <= 1e-4)
    err = (decode[:CARD_CPU_T] - cpu).abs().max().item() / cpu.abs().max().item()
    cerr = 0.0
    for k, v in cache_c.items():  # the slots written in the CPU's steps
        g, c = cache_g[k][:, :, :CARD_CPU_T], v[:, :, :CARD_CPU_T]
        if k.endswith("kv_pos"):
            cerr = max(cerr, float(not torch.equal(g, c)))
        else:
            cerr = max(cerr, (g - c).abs().max().item() / c.abs().max().item())
    checks.true(f"decode card vs CPU ({CHECK_LAYERS} layers, float32, {CARD_CPU_T} tokens): "
                f"logits within 1e-5 of the largest |logit| ({err:.3g}), caches within 1e-5 "
                f"of their largest |value| ({cerr:.3g}), kv_pos equal", err <= 1e-5
                and cerr <= 1e-5)
    eng = ServeEngine(cfg, params, slots=1, max_seq=8, device=device)
    alpha = torch.tensor(REFRESH_ALPHA, device=device)
    ops.reset_launch_counts()
    wf, words, deltas = refresh_words(torch, device, params, alpha,
                                      torch.Generator(device=device).manual_seed(8), keep=True)
    eng.apply_wire_delta(words, alpha, wf)
    counts.update(ops.launch_counts())
    worst = max(((eng.params[k] - p) - deltas[k]).abs().max().item() for k, p in params.items())
    checks.true(f"refresh ({CHECK_LAYERS} layers, float32): |applied - delta| <= 1/alpha + "
                f"1e-6 ({worst:.3g})", worst <= 1.0 / REFRESH_ALPHA + 1e-6)
    del eng, params, words, deltas
    torch.cuda.empty_cache()


def serve_deepseek(torch, ops, checks, device, counts) -> None:
    """deepseek-v2-lite-16b at full depth through ServeEngine (MLA's
    latent cache), the MoE drops counted; at CHECK_LAYERS layers, float32,
    the first greedy token of every slot on the card and on the CPU. The
    decode path launches no kernel of ours (``counts`` unchanged)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import prompts
    from repro_torch.models import moe
    from repro_torch.models.decode import init_lm_cache, lm_decode_step, tp_greedy
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.utils.tree import tree_size

    cfg = get_arch(MLA_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    tally = {"dropped": torch.zeros((), dtype=torch.int64, device=device), "pairs": 0}
    real = moe.dispatch_indices

    def counted(ids, n_experts, cap):
        flat_e, slot, keep = real(ids, n_experts, cap)
        tally["dropped"] += (~keep).sum()
        tally["pairs"] += keep.numel()
        return flat_e, slot, keep

    moe.dispatch_indices = counted
    try:
        reqs, iters, wall, steps = serve_requests(torch, eng, prompts(MLA_REQUESTS, cfg.vocab),
                                                  MLA_MAX_NEW)
    finally:
        moe.dispatch_indices = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_tok = sum(v.element_size() * v[0, 0, 0].numel() for k, v in eng.cache.items()
                  if not k.endswith("kv_pos")) * cfg.n_layers
    gqa = 2 * cfg.n_kv_heads * cfg.head_dim * 2 * cfg.n_layers
    n_tok = sum(len(r.out) for r in reqs)
    print(f"serve {MLA_ARCH}: {cfg.n_layers} layers, {tree_size(params)} params (bf16, the "
          f"router float32), {len(reqs)} requests, {iters} engine iterations "
          f"({wall / iters * 1e3:.2f} ms each on average), {len(steps)} "
          f"decode steps (median {statistics.median(steps):.2f} ms, min {min(steps):.2f}, max "
          f"{max(steps):.2f}), {n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s), "
          f"peak {peak:.2f} GiB; latent cache {per_tok} bytes a token (a GQA cache of its "
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}: {gqa}); {tally['pairs']} (token, "
          f"expert) pairs dispatched, {int(tally['dropped'])} dropped", flush=True)
    serve_checks(checks, f"serve {MLA_ARCH}", reqs, cfg.vocab)
    checks.true(f"serve {MLA_ARCH}: no (token, expert) pair dropped at {SERVE_SLOTS} slots "
                f"({int(tally['dropped'])} of {tally['pairs']})",
                tally["pairs"] > 0 and int(tally["dropped"]) == 0)
    del eng, params
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    params = init_lm_params(small, generator=torch.Generator(device=device).manual_seed(1),
                            device=device)
    first = [p[:4] for p in prompts(SERVE_SLOTS, cfg.vocab)]
    tokens = torch.tensor(first).T  # (4 steps, slots)
    picks = []  # the card's, then the CPU's
    with torch.no_grad():
        for dev in (device, torch.device("cpu")):
            p = {k: v.to(dev) for k, v in params.items()}
            cache = init_lm_cache(small, SERVE_SLOTS, 8, device=dev, dtype=torch.float32)
            for t in range(tokens.shape[0]):
                logits, cache = lm_decode_step(p, cache, tokens[t].to(dev),
                                               torch.full((SERVE_SLOTS,), t, device=dev), small,
                                               dtype=torch.float32)
            picks.append((tp_greedy(logits).cpu(), logits.cpu()))
            del p, cache
    (g_tok, g_log), (c_tok, c_log) = picks
    err = (g_log - c_log).abs().max().item() / c_log.abs().max().item()
    checks.true(f"{MLA_ARCH} ({CHECK_LAYERS} layers, float32): first greedy tokens "
                f"{g_tok.tolist()} on the card, {c_tok.tolist()} on the CPU (logits within "
                f"{err:.3g} of the largest)", torch.equal(g_tok, c_tok))
    del params
    torch.cuda.empty_cache()


def straggler_check(torch, ops, checks, device, counts) -> None:
    """Four workers' images of granite's leaves at STRAGGLER_LAYERS layers,
    worker 2 late, through runtime.straggler on packed8 and dense8."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.comm import CommCtx
    from repro_torch.models.transformer import param_shapes
    from repro_torch.runtime.straggler import decode_partial, straggler_tolerant_sum
    from repro_torch.wire import DenseInt, PackedInt

    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=STRAGGLER_LAYERS)
    shapes = param_shapes(cfg)
    n_leaves, alive = len(shapes), [True, True, False, True]
    packed, dense, ctx = PackedInt(bits=8), DenseInt(bits=8), CommCtx(n_workers=N_WORKERS)
    alpha = torch.tensor(20.0, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    seeds = torch.randint(-(2**31), 2**31, (N_WORKERS, n_leaves), generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    ops.reset_launch_counts()
    images = []
    for w in range(N_WORKERS):
        tree = {}
        for i, (k, shape) in enumerate(shapes.items()):
            g = torch.randn(shape, generator=gen, device=device)
            tree[k] = packed.encode(g, alpha, seeds[w, i], n_workers=N_WORKERS)
            del g
        images.append(tree)
    counts.update(ops.launch_counts())
    lim = packed.clip_limit(N_WORKERS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    s_p, n_live = straggler_tolerant_sum(images, alive, ctx, packed)
    torch.cuda.synchronize()
    t_sum = time.perf_counter() - t0
    run = ops.launch_counts()
    s_d, n_live_d = straggler_tolerant_sum(images, alive, ctx, dense)
    same = all(torch.equal(s_p[k], s_d[k]) for k in shapes)
    del s_d
    same &= all(torch.equal(s_p[k], sum(im[k].to(torch.int64) for im, a in
                                         zip(images, alive) if a).to(torch.int32))
                for k in shapes)
    garbage = list(images)
    garbage[2] = {k: torch.randint(-lim, lim + 1, v.shape, generator=gen, device=device,
                                   dtype=torch.int32) for k, v in images[2].items()}
    s_g, _ = straggler_tolerant_sum(garbage, alive, ctx, packed)
    del garbage
    same &= all(torch.equal(s_p[k], s_g[k]) for k in shapes)
    del s_g
    ghat, dead = decode_partial(s_p, alpha, n_live)
    plain = all(torch.equal(ghat[k], s_p[k].float() / (torch.clamp(n_live, min=1).float()
                                                       * alpha)) for k in shapes)
    s0, n0 = straggler_tolerant_sum(images, [False] * N_WORKERS, ctx, packed)
    g0, dead0 = decode_partial(s0, alpha, n0)
    counts.update(ops.launch_counts())
    print(f"straggler: {n_leaves} leaves, {sum(math.prod(s) for s in shapes.values())} "
          f"coordinates, 4 workers (worker 2 late), packed8 sum {t_sum * 1e3:.1f} ms with "
          f"launches {run}", flush=True)
    checks.true("straggler: packed8 and dense8 sums bit-equal, equal to the int64 sum of the "
                "three alive images, unchanged by the dead worker's garbage", same)
    checks.true(f"straggler: n_live {int(n_live)} (dense8 {int(n_live_d)}) == 3, decode_partial "
                "bit-equal to s.float() / (max(n_live, 1)·α), not all dead",
                int(n_live) == int(n_live_d) == 3 and plain and not bool(dead))
    checks.true(f"straggler: an all-dead round: n_live {int(n0)}, flagged, finite",
                int(n0) == 0 and bool(dead0) and all(bool(v.isfinite().all()) for v in g0.values()))
    want = {k.name: 0 for k in ops.KERNELS}
    want.update(pack_words=N_WORKERS * n_leaves, unpack_words=n_leaves)
    checks.true(f"straggler: launches {run} (expected {want})", run == want)
    del images, s_p, ghat, s0, g0
    torch.cuda.empty_cache()


def elastic_check(torch, ops, checks, device, counts) -> None:
    """The elastic protocol at granite's width: 4 workers, a checkpoint,
    the re-plan for a failed worker, the resume at 3."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.launch.train import OPTIMIZERS, train_loop
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap
    from repro_torch.runtime import plan_after_failures

    cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=CHECK_LAYERS)
    plan = plan_after_failures(dp=N_WORKERS, tp=1, failed_devices=[3], global_batch=N_WORKERS,
                               wire="packed8", keep_global_batch=False)
    print(f"elastic: {plan}", flush=True)
    checks.true("elastic: the plan keeps 3 workers, clip limit 31->42",
                plan.n_dp == 3 and "clip limit 31->42" in plan.note)
    kw = dict(compressor="intsgd8_packed", wire="packed8", fused=True, opt="sgd", lr=0.3,
              device=device, log_every=100)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_", dir=ROOT / "build")
    try:
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        _, h4 = train_loop(cfg, ShapeConfig("elastic", ELASTIC_SEQ, N_WORKERS, "train"),
                           n_workers=N_WORKERS, steps=4, ckpt=CheckpointStore(tmp),
                           ckpt_every=4, **kw)
        first = ops.launch_counts()
        n = plan.n_dp
        shape = ShapeConfig("elastic", ELASTIC_SEQ, plan.global_batch, "train")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, h3 = train_loop(cfg, shape, n_workers=n, steps=8, ckpt=CheckpointStore(tmp),
                           ckpt_every=1000, resume=True, **kw)
        t_resume = time.perf_counter() - t0
        resumed = ops.launch_counts()
        # a fresh 3-worker loop from the restored state
        comp, base_opt = make_compressor("intsgd8_packed"), OPTIMIZERS["sgd"]()
        art = build_train_step(cfg, shape, n_workers=n, compressor=comp, base_opt=base_opt,
                               lr_schedule=warmup_wrap(constant(0.3), 5),
                               param_dtype=torch.float32, fused=True, clip_norm=1.0,
                               device=device)
        like = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                              device=device)
        opt_state, comp_state = build_init_state(like, n_workers=n, compressor=comp,
                                                 base_opt=base_opt, fused=True)
        state, _, start = CheckpointStore(tmp).restore(
            {"params": like, "opt": opt_state, "comp": comp_state})
        del like, opt_state, comp_state
        p, o, c = state["params"], state["opt"], state["comp"]
        del state
        gen, n_leaves = torch.Generator().manual_seed(0), len(art.layout.names)
        for _ in range(start):
            leaf_seeds(gen, n, n_leaves, "cpu")
        data = SyntheticLMData(cfg.vocab, ELASTIC_SEQ, plan.global_batch, seed=0)
        ops.reset_launch_counts()
        fresh = []
        for i in range(start, 8):
            p, o, c, loss, m = art.steps["compressed"](p, o, c, i, data.batch(i, 0, device=device),
                                                       leaf_seeds(gen, n, n_leaves, device))
            fresh.append(float(loss))
        fresh_counts = ops.launch_counts()
        del p, o, c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for run in (first, resumed, fresh_counts):
        counts.update(run)
    torch.cuda.empty_cache()
    print(f"elastic: 4 workers {[round(r['loss'], 4) for r in h4]}, resumed at "
          f"{h3[0]['step']} with 3 workers {[r['loss'] for r in h3]} (max_int "
          f"{[r['max_int'] for r in h3]}, {t_resume:.1f} s with the restore), fresh 3-worker "
          f"loop {fresh}", flush=True)
    gaps = [abs(a["loss"] - b) / abs(b) for a, b in zip(h3, fresh)]
    checks.true(f"elastic: resumed at step {start}: {len(h3)} steps at 3 workers, losses finite "
                f"and within 1e-2 of the fresh loop's (gaps {[float(f'{g:.3g}') for g in gaps]}), "
                f"max_int <= 3 x 42", start == 4 and len(h3) == 4 == len(gaps)
                and all(math.isfinite(r["loss"]) for r in h3 + h4) and all(g < 1e-2 for g in gaps)
                and all(0 < r["max_int"] <= 3 * 42 for r in h3))
    n_leaves = len(art.layout.names)
    want4, _, _ = expected_launches(ops, n_leaves, 4, "sgd", "intsgd", "packed8", fused=True,
                                    microbatches=1)
    want3 = {k.name: 0 for k in ops.KERNELS}  # 4 compressed steps at 3 workers
    want3.update(int_compress=4 * n * n_leaves, pack_words=4 * n * n_leaves,
                 unpack_words=4 * n_leaves, fused_unpack_sgd=4 * n_leaves,
                 block_norms=2 * 4 * n_leaves)
    checks.true(f"elastic: launches {first}, {resumed}, {fresh_counts} (expected {want4}, "
                f"{want3}, {want3})", first == want4 and resumed == want3 == fresh_counts)


def serve_runtime_phase(torch, ops, checks, device) -> collections.Counter:
    """Phase 21: the serve path and the runtime (see the module docstring).
    Returns the launch counts of every part, each part's zeroed just before
    it and read just after."""
    counts = collections.Counter()
    for name, part in (("serve granite and refresh", serve_granite),
                       ("float32 checks", f32_checks), ("serve deepseek", serve_deepseek),
                       ("straggler", straggler_check), ("elastic", elastic_check)):
        t0 = time.perf_counter()
        gc.collect()  # each part starts from the card's memory freed, cycles too
        torch.cuda.empty_cache()
        print(f"phase 21 {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated at "
              "the start", flush=True)
        part(torch, ops, checks, device, counts)
        print(f"phase 21 {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return counts


# phase 22: the recurrent and encoder-decoder decode at published width
HYBRID_ARCH, SSM_ARCH = "zamba2-2.7b", "xlstm-125m"
ENCDEC_SEQS, ENCDEC_FRAMES, ENCDEC_NEW = 4, 2048, 16
ENCDEC_CHECK_FRAMES = 256


def state_bytes(eng, cfg) -> tuple:
    """(bytes of one slot's cache, the recurrent state's share of it, a
    GQA cache's bytes a slot at max_seq for every layer at the config's
    widths and the engine's cache type)."""
    slot = sum(v.element_size() * v.numel() // eng.slots for v in eng.cache.values())
    rec = sum(v.element_size() * v.numel() // eng.slots for k, v in eng.cache.items()
              if k.startswith(("mamba/", "blocks/")))
    gqa = cfg.n_layers * eng.max_seq * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    return slot, rec, gqa


def serve_recurrent(torch, ops, checks, device, counts, arch, refresh) -> None:
    """``arch`` at full depth through ServeEngine with phase 21's traffic;
    with ``refresh``, then the weight refresh over packed8 (the largest
    leaf held bit-equal to the plain path)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import prompts
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.utils.tree import tree_size

    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(0),
                            device=device, dtype=torch.bfloat16)
    eng = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    ops.reset_launch_counts()
    reqs, iters, wall, steps = serve_requests(torch, eng, prompts(SERVE_REQUESTS, cfg.vocab),
                                              SERVE_MAX_NEW)
    served = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(r.out) for r in reqs)
    host, card = host_card_ms(torch, lambda: ServeEngine.step(eng))
    slot, rec, gqa = state_bytes(eng, cfg)
    print(f"serve {arch}: {cfg.n_layers} layers, {tree_size(params)} bf16 params, "
          f"{len(reqs)} requests, {iters} engine iterations ({wall / iters * 1e3:.2f} ms each on "
          f"average), {len(steps)} decode steps (median {statistics.median(steps):.2f} ms, min "
          f"{min(steps):.2f}, max {max(steps):.2f}; each synchronized), {n_tok} tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tokens/s), peak {peak:.2f} GiB; one step: host "
          f"enqueue {host:.2f} ms, card {card:.2f} ms, host over card {host / card:.2f}; cache "
          f"{slot} bytes a slot, of which recurrent state {rec} (a GQA cache of "
          f"{cfg.n_layers} layers at max_seq {SERVE_MAX_SEQ}: {gqa}); launches {served}",
          flush=True)
    serve_checks(checks, f"serve {arch}", reqs, cfg.vocab)
    checks.true(f"serve {arch}: the decode path launches no kernel of ours ({served})",
                not any(served.values()))
    if refresh:
        largest = max(params, key=lambda k: params[k].numel())
        refresh_full(torch, ops, checks, device, eng, params, counts, label=arch,
                     held=[largest])
    del eng, params
    torch.cuda.empty_cache()


def encdec_serve(torch, ops, checks, device, counts) -> None:
    """seamless-m4t-medium at full depth, bf16: the prefill of
    ENCDEC_SEQS sequences of ENCDEC_FRAMES frames, then a greedy loop of
    ENCDEC_NEW encdec_decode_step tokens."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import encdec
    from repro_torch.models.decode import tp_greedy

    cfg = get_arch(ENCDEC_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = encdec.init_encdec_params(cfg, generator=torch.Generator(device=device)
                                       .manual_seed(0), device=device, dtype=torch.bfloat16)
    frames = torch.randn(ENCDEC_SEQS, ENCDEC_FRAMES, cfg.frontend_dim, device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    b = ENCDEC_SEQS
    ops.reset_launch_counts()
    with torch.no_grad():
        cache = encdec.init_encdec_cache(cfg, b, ENCDEC_NEW, ENCDEC_FRAMES, device=device)
        prefill = []  # the first, then again warm
        for _ in range(2):
            t0 = time.perf_counter()
            cache = encdec.encdec_prefill(params, frames, cache, cfg)
            torch.cuda.synchronize()
            prefill.append((time.perf_counter() - t0) * 1e3)
        tok = torch.ones(b, dtype=torch.long, device=device)
        out, steps, finite = [], [], True
        t_loop = time.perf_counter()
        for t in range(ENCDEC_NEW):
            t0 = time.perf_counter()
            logits, cache = encdec.encdec_decode_step(params, cache, tok,
                                                      torch.full((b,), t, device=device), cfg)
            tok = tp_greedy(logits)
            out.append(tok.tolist())  # the loop's one read to the host a step
            steps.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(logits).all())
        wall = time.perf_counter() - t_loop
        pos = torch.full((b,), ENCDEC_NEW - 1, device=device)
        host, card = host_card_ms(torch, lambda: encdec.encdec_decode_step(
            params, cache, tok, pos, cfg))
    served = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    cross = sum(v.element_size() * v.numel() for k, v in cache.items() if k.startswith("cross/"))
    print(f"decode {ENCDEC_ARCH}: {cfg.enc_layers} + {cfg.dec_layers} layers, bf16, {b} "
          f"sequences of {ENCDEC_FRAMES} frames: prefill {prefill[0]:.2f} ms, again "
          f"{prefill[1]:.2f} ms (cross cache {cross} "
          f"bytes); {ENCDEC_NEW} greedy steps (median {statistics.median(steps):.2f} ms, min "
          f"{min(steps):.2f}, max {max(steps):.2f}; each ending in the tokens' read), "
          f"{b * ENCDEC_NEW} tokens in {wall:.3f} s ({b * ENCDEC_NEW / wall:.1f} tokens/s), peak "
          f"{peak:.2f} GiB; one step: host enqueue {host:.2f} ms, card {card:.2f} ms, host over "
          f"card {host / card:.2f}; launches {served}", flush=True)
    checks.true(f"decode {ENCDEC_ARCH}: logits finite, {b * ENCDEC_NEW} greedy tokens in "
                f"[0, {cfg.vocab}), no kernel of ours launched",
                finite and all(0 <= t < cfg.vocab for row in out for t in row)
                and not any(served.values()))
    del params, cache, frames
    torch.cuda.empty_cache()


def small_config(arch):
    """``arch`` at CHECK_LAYERS layers: xlstm one (m, m, s) block of 3;
    zamba2 with attn_every 2, so that the shared block runs once; seamless
    2 + 2."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=3)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=CHECK_LAYERS, attn_every=CHECK_LAYERS)
    return dataclasses.replace(cfg, enc_layers=CHECK_LAYERS, dec_layers=CHECK_LAYERS,
                               n_layers=2 * CHECK_LAYERS)


def f32_decode_checks(torch, checks, device, label, step, want, make_cache) -> None:
    """``step(device, cache, t)`` -> logits (1, V) on ``device``: the card
    steps TRAIN_DECODE_T tokens, its logits within 1e-4 of ``want`` (T, V)'s
    largest |logit|; the CPU steps CARD_CPU_T, its logits and cache within
    1e-5 of the card's after as many."""
    runs = []  # the card's, then the CPU's
    with torch.no_grad():
        for i, dev in enumerate((device, torch.device("cpu"))):
            cache, got, snap = make_cache(dev), [], None
            for t in range(CARD_CPU_T if i else TRAIN_DECODE_T):
                got.append(step(dev, cache, t)[0].cpu())
                if t == CARD_CPU_T - 1:
                    snap = {k: v.cpu().clone() for k, v in cache.items()}
            runs.append((torch.stack(got), snap))
            del cache
    (decode, cache_g), (cpu, cache_c) = runs
    err = (decode - want).abs().max().item() / want.abs().max().item()
    checks.true(f"train == decode ({label}, float32, {TRAIN_DECODE_T} tokens): logits within "
                f"1e-4 of the largest |logit| ({err:.3g})", err <= 1e-4)
    err = (decode[:CARD_CPU_T] - cpu).abs().max().item() / cpu.abs().max().item()
    cerr = 0.0
    for k, c in cache_c.items():
        g = cache_g[k]
        if not c.is_floating_point():
            cerr = max(cerr, float(not torch.equal(g, c)))
        elif c.abs().max().item() > 0:
            cerr = max(cerr, (g.float() - c.float()).abs().max().item() / c.abs().max().item())
    checks.true(f"decode card vs CPU ({label}, float32, {CARD_CPU_T} tokens): logits within "
                f"1e-5 of the largest |logit| ({err:.3g}), caches within 1e-5 of their largest "
                f"|value| ({cerr:.3g}), integers equal", err <= 1e-5 and cerr <= 1e-5)


def recurrent_f32_checks(torch, ops, checks, device, counts) -> None:
    """zamba2 and xlstm at their small configs, float32: train == decode
    and card against CPU."""
    from repro_torch.models.decode import init_lm_cache, lm_decode_step
    from repro_torch.models.transformer import init_lm_params, lm_forward, lm_logits

    for arch in (HYBRID_ARCH, SSM_ARCH):
        cfg = small_config(arch)
        params = init_lm_params(cfg, generator=torch.Generator(device=device).manual_seed(1),
                                device=device)
        tokens = torch.randint(0, cfg.vocab, (1, TRAIN_DECODE_T),
                               generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            want = lm_logits(params, lm_forward(params, {"tokens": tokens.to(device)}, cfg,
                                                torch.float32), cfg)[0].cpu()
        on = {"cpu": {k: v.cpu() for k, v in params.items()}, "cuda": params}

        def step(dev, cache, t):
            logits, _ = lm_decode_step(on[dev.type], cache, tokens[:, t].to(dev),
                                       torch.full((1,), t, device=dev), cfg, dtype=torch.float32)
            return logits

        f32_decode_checks(torch, checks, device, f"{arch}, {cfg.n_layers} layers", step,
                          want, lambda dev: init_lm_cache(cfg, 1, TRAIN_DECODE_T, device=dev,
                                                          dtype=torch.float32))
        del params, on
        torch.cuda.empty_cache()


def encdec_f32_checks(torch, ops, checks, device, counts) -> None:
    """seamless at 2 + 2 layers, float32, one sequence of
    ENCDEC_CHECK_FRAMES frames: decode == decode_states and card against
    CPU (the prefill's cross cache included)."""
    from repro_torch.models import encdec

    cfg = small_config(ENCDEC_ARCH)
    params = encdec.init_encdec_params(cfg, generator=torch.Generator(device=device)
                                       .manual_seed(1), device=device)
    frames = torch.randn(1, ENCDEC_CHECK_FRAMES, cfg.frontend_dim,
                         generator=torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab, (1, TRAIN_DECODE_T),
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        enc = encdec.encode(params, frames.to(device), cfg, torch.float32)
        h = encdec.decode_states(params, enc, tokens.to(device), cfg, torch.float32)
        want = (h @ params["lm_head"])[0].cpu()
        del enc, h
    on = {"cpu": {k: v.cpu() for k, v in params.items()}, "cuda": params}

    def make_cache(dev):
        cache = encdec.init_encdec_cache(cfg, 1, TRAIN_DECODE_T, ENCDEC_CHECK_FRAMES, device=dev,
                                         dtype=torch.float32)
        return encdec.encdec_prefill(on[dev.type], frames.to(dev), cache, cfg, torch.float32)

    def step(dev, cache, t):
        logits, _ = encdec.encdec_decode_step(on[dev.type], cache, tokens[:, t].to(dev),
                                              torch.full((1,), t, device=dev), cfg,
                                              dtype=torch.float32)
        return logits

    f32_decode_checks(torch, checks, device, f"{ENCDEC_ARCH}, {cfg.enc_layers} + "
                      f"{cfg.dec_layers} layers, {ENCDEC_CHECK_FRAMES} frames", step, want,
                      make_cache)
    del params, on
    torch.cuda.empty_cache()


def recurrent_decode_phase(torch, ops, checks, device) -> collections.Counter:
    """Phase 22: the recurrent and encoder-decoder decode (see the module
    docstring). Returns the launch counts of every part, each part's zeroed
    just before it and read just after."""
    counts = collections.Counter()
    for name, part in (("serve zamba2 and refresh", functools.partial(
                            serve_recurrent, arch=HYBRID_ARCH, refresh=True)),
                       ("serve xlstm", functools.partial(serve_recurrent, arch=SSM_ARCH,
                                                         refresh=False)),
                       ("seamless prefill and decode", encdec_serve),
                       ("recurrent float32 checks", recurrent_f32_checks),
                       ("seamless float32 checks", encdec_f32_checks)):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 22 {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated at "
              "the start", flush=True)
        part(torch, ops, checks, device, counts)
        print(f"phase 22 {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return counts


# phase 23: tensor parallelism on a 2 x 2 grid of gloo ranks sharing the card:
# (label, arch, layers, steps, optimizer, compressor, wire, lr, fused, param type);
# seamless's layers are its encoder's and its decoder's each
TP_GRID = (2, 2)  # (data, model)
TP_PATHS = (
    ("tp granite-fused-sgd-bf16", "granite-8b", 2, 3, "sgd", "intsgd", "packed8", 0.3, True,
     "bfloat16"),
    ("tp deepseek-zero1-adamw", "deepseek-v2-lite-16b", 1, 3, "adamw", "intsgd", "packed8",
     3e-4, False, "float32"),
    ("tp zamba2-fused-sgd-bf16", "zamba2-2.7b", 9, 3, "sgd", "intsgd", "packed8", 0.3, True,
     "bfloat16"),
    ("tp xlstm-zero1-adamw", "xlstm-125m", 3, 3, "adamw", "intsgd", "packed8", 3e-4, False,
     "float32"),
    ("tp seamless-fused-sgd-bf16", "seamless-m4t-medium", 2, 3, "sgd", "intsgd", "packed8", 0.3,
     True, "bfloat16"),
)
TP_SEQ = 2048
# the families whose tp = 2 function of the same global params is not their
# tp = 1 function (the reference's contiguous split of Mamba2's w_xz and the
# mLSTM's w_if and if_bias, and its gated norms over the local shard): their
# step-0 gap to tp = 1 is printed, and their smoke configs' exact step on the
# grid is held card against CPU instead
TP_SPLIT = ("zamba2-2.7b", "xlstm-125m")
# (arch, param type, fused, optimizer, lr, tolerance of the card-CPU loss gap)
TP_SMOKE = (("zamba2-2.7b", "bfloat16", True, "sgd", 0.3, 1e-2),
            ("xlstm-125m", "float32", False, "adamw", 3e-4, 1e-3))
TP_SMOKE_SEQ = 64
# the dropped share of (token, choice) pairs at init: 14-19 % at tp = 1 (phase
# 17); capacity is counted on each rank's half of the tokens here
MAX_DROPPED = 0.3


def tp_cfg(arch: str, layers: int):
    """``arch`` with its depth cut to ``layers`` (the encoder-decoder: that
    many encoder and decoder layers each)."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch(arch)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, enc_layers=layers, dec_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers)


def tp_train(torch, cfg, shape, *, n_workers, comp, wire, steps, lr, fused, opt, dtype, device,
             grid=None, on_step=None, compressor=None, **ckpt):
    """One TP path's ``(params, history)`` through the user entry point:
    ``train_loop`` (``ckpt`` its ``ckpt``, ``ckpt_every`` and ``resume``),
    or for a frontend config :func:`vlm_loop`; ``compressor`` (a name or a
    ``Compressor``) in place of ``comp``'s registry name."""
    from repro_torch.launch.train import train_loop

    kw = dict(n_workers=n_workers, compressor=compressor or compressor_name(comp, wire),
              wire=wire,
              steps=steps, lr=lr, log_every=1, seed=0, fused=fused, clip_norm=1.0, opt=opt,
              param_dtype=getattr(torch, dtype), device=device, grid=grid,
              on_step=on_step or (lambda i, p: None))
    if cfg.frontend is not None:
        return vlm_loop(torch, cfg, shape, microbatches=1, group=None, overlap="off", **kw)
    return train_loop(cfg, shape, **kw, **ckpt)


def tp_smoke_card_cpu(torch, grid, device) -> dict:
    """Each ``TP_SMOKE`` config's smoke size through ``build_train_step``'s
    exact step on the grid, on the card and then on the CPU (the same gloo
    groups), from the same params (the global draw on the CPU, this rank's
    shard), batch and seeds: {arch: (card loss, CPU loss)}."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch import specs
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap

    out = {}
    for arch, dtype, fused, opt, lr, _ in TP_SMOKE:
        cfg = smoke_config(get_arch(arch))
        shape = ShapeConfig("chip-smoke-tp", TP_SMOKE_SEQ, 2 * grid.n_dp, "train")
        param_dtype = getattr(torch, dtype)
        params0 = specs.tp_shard(cfg, grid.tp, grid.tp_index).tree(init_lm_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu", dtype=param_dtype,
            tp=grid.tp))
        batch0 = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0).batch(0, 0)
        losses = []
        for dev in (device, torch.device("cpu")):
            comp, base_opt = make_compressor("intsgd8_packed"), OPTIMIZERS[opt]()
            art = build_train_step(
                cfg, shape, n_workers=grid.n_dp, compressor=comp, base_opt=base_opt,
                lr_schedule=warmup_wrap(constant(lr), 5), param_dtype=param_dtype, fused=fused,
                clip_norm=1.0, device=dev, grid=grid)
            params = {k: v.to(dev) for k, v in params0.items()}
            opt_state, comp_state = build_init_state(params, n_workers=grid.n_dp,
                                                     compressor=comp, base_opt=base_opt,
                                                     fused=fused, grid=grid)
            seeds = leaf_seeds(torch.Generator().manual_seed(0), grid.n_dp,
                               len(art.layout.names), dev, 1)
            loss = art.steps["exact"](params, opt_state, comp_state, 0,
                                      {k: v.to(dev) for k, v in batch0.items()}, seeds)[3]
            losses.append(float(loss))
            del params, opt_state, comp_state
        out[arch] = tuple(losses)
    torch.cuda.empty_cache()
    return out


def tp_rank_paths(group, rank, paths, device, tmp):
    """One rank of phase 23: each path (``tp_train``) on this rank's shard of
    the grid, on the shared card; per path the history, the params'
    checksums after every step, the kernel launches, the model axis's
    calls, the all-to-all's time, the MoE dropped pairs and the peak
    memory; then the smoke configs card against CPU. A ``CKPT_PATHS`` path
    is also phase 24's uninterrupted run: deterministic, saving a
    checkpoint under ``tmp`` after its second step (the store's seconds and
    bytes in its result)."""
    import torch
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe
    from repro_torch.parallel import collectives as coll

    device = torch.device(device)
    torch.cuda.set_device(device)
    grid = make_debug_mesh(*TP_GRID)
    exchange, dispatch_indices = coll.exchange_tp, moe.dispatch_indices
    a2a_s, dropped = [], []

    def timed_exchange(x, g):  # the card's queue drained on both sides
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = exchange(x, g)
        torch.cuda.synchronize(device)
        a2a_s.append(time.perf_counter() - t0)
        return out

    def counted_dispatch(ids, n_experts, cap):
        flat_e, slot, keep = dispatch_indices(ids, n_experts, cap)
        dropped.append(torch.stack([(~keep).sum(), torch.tensor(keep.numel(),
                                                                device=keep.device)]))
        return flat_e, slot, keep

    coll.exchange_tp, moe.dispatch_indices = timed_exchange, counted_dispatch
    out = []
    try:
        for label, arch, layers, steps, opt, comp, wire, lr, fused, dtype in paths:
            cfg = tp_cfg(arch, layers)
            shape = ShapeConfig("chip-smoke", TP_SEQ, 2 * TP_GRID[0], "train")
            sums = []

            def on_step(i, p):
                sums.append(params_checksums(torch, p))
                torch.cuda.empty_cache()  # four ranks share the card

            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            coll.reset_tp_counts()
            a2a_s.clear()
            dropped.clear()
            ckpt = {}
            if label in CKPT_PATHS:
                ckpt = dict(ckpt=CheckpointStore(
                    os.path.join(tmp, arch), grid=grid,
                    specs=specs.infer_param_specs(cfg, grid.tp)[2]), ckpt_every=CKPT_STEPS - 1)
            with deterministic(torch) if ckpt else contextlib.nullcontext():
                params, history = tp_train(
                    torch, cfg, shape, n_workers=grid.n_dp, comp=comp, wire=wire, steps=steps,
                    lr=lr, fused=fused, opt=opt, dtype=dtype, device=device, grid=grid,
                    on_step=on_step, **ckpt)
            if ckpt:
                ckpt["ckpt"].close()
            drops = torch.stack(dropped).sum(0).tolist() if dropped else [0, 0]
            out.append(dict(history=history, checksums=sums, n_leaves=len(params),
                            launches=ops.launch_counts(), bf16=ops.bf16_launch_counts(),
                            tp=coll.tp_counts(), a2a_ms=1e3 * sum(a2a_s), n_a2a=len(a2a_s),
                            dropped=drops, grid=(grid.dp_index, grid.tp_index),
                            dtypes=sorted({str(p.dtype) for p in params.values()}),
                            peak=torch.cuda.max_memory_allocated() / 2**30,
                            reserved=torch.cuda.max_memory_reserved() / 2**30,
                            stats=dict(ckpt["ckpt"].stats) if ckpt else None))
            del params
    finally:
        coll.exchange_tp, moe.dispatch_indices = exchange, dispatch_indices
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smoke = tp_smoke_card_cpu(torch, grid, device)
    return dict(paths=out, smoke=smoke, smoke_s=time.perf_counter() - t0)


def tp_references(torch, ops, device):
    """Phase 23's tp = 1 references: each path's step 0 on the local
    backend (the same global weights: no config pads at tp = 2). Returns
    ``(step-0 losses by label, launch counts)``."""
    from repro_torch.configs.base import ShapeConfig

    launches = collections.Counter()
    n_dp, _ = TP_GRID
    step0 = {}
    for label, arch, layers, steps, opt, comp, wire, lr, fused, dtype in TP_PATHS:
        cfg = tp_cfg(arch, layers)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        params, hist = tp_train(
            torch, cfg, ShapeConfig("chip-smoke", TP_SEQ, 2 * n_dp, "train"), n_workers=n_dp,
            comp=comp, wire=wire, steps=1, lr=lr, fused=fused, opt=opt, dtype=dtype,
            device=device)
        launches.update(ops.launch_counts())
        step0[label] = hist[0]["loss"]
        print(f"{label} (tp = 1, local n = {n_dp}): step-0 loss {step0[label]!r}, "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return step0, launches


def tp_checks(torch, ops, checks, ranks, step0, free) -> collections.Counter:
    """Phase 23's checks on each rank's :func:`tp_rank_paths` result against
    the tp = 1 step-0 losses. Returns every rank's launch counts."""
    launches = collections.Counter()
    n_dp, tp = TP_GRID
    print(f"tp: {n_dp} x {tp} grid of gloo ranks on one card, {len(TP_PATHS)} paths and the "
          f"smoke configs (the smoke configs {max(r['smoke_s'] for r in ranks):.1f}s)",
          flush=True)
    for pi, (label, arch, layers, steps, opt, comp, wire, lr, fused, dtype) in enumerate(
            TP_PATHS):
        res = [r["paths"][pi] for r in ranks]
        checks.true(f"{label}: ranks on grid places {[r['grid'] for r in res]}",
                    [r["grid"] for r in res] == [divmod(i, tp) for i in range(n_dp * tp)])
        checks.true(f"{label}: params {res[0]['dtypes']}", all(
            r["dtypes"] == [f"torch.{dtype}"] for r in res))
        hist = res[0]["history"]
        for r in res:
            checks.true(f"{label}: rank {r['grid']} losses finite",
                        all(math.isfinite(h["loss"]) for h in r["history"]))
        lim_sum = wire_limits(comp, wire, n_dp, 1)[1]
        checks.true(f"{label}: max_int <= {lim_sum} on every compressed step, every rank "
                    f"({[h['max_int'] for h in hist[1:]]})",
                    all(0 < h["max_int"] <= lim_sum for r in res for h in r["history"][1:]))
        for step in range(steps):
            for t in range(tp):
                sums = [res[d * tp + t]["checksums"][step] for d in range(n_dp)]
                checks.true(f"{label}: step {step}: the {n_dp} dp replicas of model shard {t} "
                            f"bit-identical ({len(sums[0])} leaves' checksums)",
                            all(x == sums[0] for x in sums))
        gap = abs(hist[0]["loss"] - step0[label]) / abs(step0[label])
        if arch in TP_SPLIT:  # another function at tp = 2 (the reference's)
            print(f"  {label}: step-0 loss {hist[0]['loss']!r} on the grid, {step0[label]!r} "
                  f"at tp = 1 (relative gap {gap:.3g}: the reference's split packed leaves "
                  f"and local gated norms; not a check)", flush=True)
        else:
            checks.true(f"{label}: step-0 loss {hist[0]['loss']!r} on the grid within 1e-2 of "
                        f"{step0[label]!r} at tp = 1 (relative gap {gap:.3g})", gap < 1e-2)
        want, _, want_bf16 = expected_launches(
            ops, res[0]["n_leaves"], steps, opt, comp, wire, fused=fused, microbatches=1,
            n_local=1, param_dtype=dtype, n_workers=n_dp)
        for r in res:
            ok = all(r["launches"][k] == want[k] and r["bf16"][k] == want_bf16[k]
                     for k in want)
            checks.true(f"{label}: rank {r['grid']} launches {r['launches']} (expected {want}), "
                        f"bf16 {r['bf16']} (expected {want_bf16})", ok)
            launches.update(r["launches"])
        if arch == "deepseek-v2-lite-16b":
            d, n = (sum(r["dropped"][i] for r in res) for i in (0, 1))
            checks.true(f"{label}: MoE dropped share {d}/{n} = {d / max(n, 1):.4f} "
                        f"(< {MAX_DROPPED})", n > 0 and d / n < MAX_DROPPED)
            checks.true(f"{label}: all-to-all calls {[r['n_a2a'] for r in res]} "
                        f"(4 a layer and step)", all(r["n_a2a"] == 4 * layers * steps
                                                     for r in res))
        for r in res:
            print(f"  {label}: rank {r['grid']}: step ms "
                  f"{[round(h['ms'], 1) for h in r['history']]}, peak {r['peak']:.1f} GiB "
                  f"({r['reserved']:.1f} reserved), psum_tp {r['tp'].get('psum_tp', 0) / steps:g}"
                  f" forward + {r['tp'].get('psum_tp_backward', 0) / steps:g} backward a step, "
                  f"all-to-all {r['a2a_ms'] / steps:.1f} ms a step over {r['n_a2a'] // steps} "
                  f"calls (4 processes time-sharing one card, gloo staging through the host: "
                  f"not a transport speed)", flush=True)
        print(f"  {label}: losses {[h['loss'] for h in hist]!r}, the ranks' reserved peaks sum "
              f"to {sum(r['reserved'] for r in res):.1f} GiB of the {free / 2**30:.2f} free",
              flush=True)
    for arch, dtype, _, _, _, tol in TP_SMOKE:
        for r, (dp_i, tp_i) in zip(ranks, (divmod(i, tp) for i in range(n_dp * tp))):
            card, cpu = r["smoke"][arch]
            gap = abs(card - cpu) / abs(cpu)
            checks.true(f"tp smoke {arch} ({dtype} params): rank ({dp_i}, {tp_i}) exact-step "
                        f"loss on the card {card!r}, on the CPU {cpu!r}, relative gap "
                        f"{gap:.3g} < {tol:g}", math.isfinite(card) and gap < tol)
    return launches


# phase 24: checkpoints and the elastic resume on the 2 x 2 grid, and TP serving.
# The TP_PATHS paths checkpointed: phase 23's run of each is the uninterrupted
# one (deterministic, saving after its second step), so phase 24 resumes it
CKPT_PATHS = ("tp granite-fused-sgd-bf16", "tp deepseek-zero1-adamw")
CKPT_STEPS = 3  # the uninterrupted run; the checkpoint after its second step
ELASTIC_FAILED = (3,)  # the lost rank: data replica 1 retires whole
# (arch, layers): granite's 36 layers cut to 12 to keep the script's phases
# near 780 s (at 36 they took 324-332 ms a decode step a rank, 74 psum_tp a
# step, on an NVIDIA H100 80GB HBM3 at 700 W; this phase 148.6 s and all
# phases 928.4 s there, on a slow host)
SERVE_TP = (("granite-8b", 12), ("deepseek-v2-lite-16b", 4))
SERVE_TP_BATCH, SERVE_TP_MAX_SEQ, SERVE_TP_NEW = 4, 128, 16
SP_LAYERS, SP_MAX_SEQ, SP_STEPS, SP_PROMPT = 4, 64, 48, 5
TP_LOGIT_TOL = 2e-2  # of the largest |logit|: step 0's bound and the near-tie bound
# step 0's activations on the served bf16 cache: float32 (held to TP_LOGIT_TOL),
# then bf16 as served (printed: the model axis sums bf16 partial products, tp = 1
# one float32 product)
STEP0_DTYPES = ("float32", "bfloat16")
# every step of the teacher-forced stream (tp = 1's fed tokens), float32
# activations and cache: the grid and tp = 1 differ only in the order of
# float32 sums. A bf16 cache rounds k and v, and a sum order that moves a value
# across a bf16 rounding boundary moves it a whole bf16 step, which later layers
# carry to the logits (~1e-3 of the largest past a few layers)
F32_LOGIT_TOL = 1e-4  # of the row's largest |logit| at that step


def tp_serve_params(torch, cfg, tp: int, tp_index, device) -> dict:
    """Random bf16 serve params of ``cfg``, global and padded for ``tp``
    (the MoE router float32), drawn a layer at a time (a hybrid block, an
    encoder or decoder layer) from generators seeded by the leaf's name and
    layer: uniform ±1/√fan_in, the ``CONSTANT_INIT`` leaves filled (the
    encoder-decoder's LayerNorms and MLP biases by ``encdec._constant``),
    the ``ZERO_INIT`` ones zero, the mLSTM's ``if_bias`` as
    ``init_lm_params`` fills it. With ``tp_index`` only that
    rank's slice of each layer is kept, so no rank holds a whole leaf; with
    None the whole tree, of which the ranks' shards are the slices."""
    import zlib

    from repro_torch.launch import specs
    from repro_torch.models.common import dense_init
    from repro_torch.models.encdec import _constant as encdec_constant
    from repro_torch.models.transformer import CONSTANT_INIT, FLOAT32_LEAVES, ZERO_INIT

    g, lo, spec = specs.infer_param_specs(cfg, tp)
    out = {}
    for name, shape in g.items():
        dt = torch.float32 if name in FLOAT32_LEAVES else torch.bfloat16
        lead = 1 if name.startswith(("layers/", "enc_layers/", "dec_layers/")) else 0
        dim = None if tp_index is None or spec[name] is None else spec[name] - lead
        leaf = torch.empty(shape if tp_index is None else lo[name], dtype=dt, device=device)
        for i in range(shape[0] if lead else 1):
            sub = shape[lead:]
            const = (encdec_constant(name) if cfg.family == "encdec"
                     else CONSTANT_INIT.get(name.rsplit("/", 1)[-1]))
            if const is not None or name.endswith(ZERO_INIT):
                t = torch.full(sub, const or 0.0, dtype=dt, device=device)
            elif name.endswith("cell/if_bias"):  # [-2]·H ++ [3]·H, as init_lm_params
                t = torch.full(sub, -2.0, dtype=dt, device=device)
                t[..., sub[-1] // 2:] = 3.0
            else:
                gen = torch.Generator(device=device).manual_seed(
                    zlib.crc32(f"{name}/{i}".encode()))
                t = dense_init(sub, cfg.d_model if name == "embed" else sub[-2], generator=gen,
                               device=device, dtype=dt)
            if dim is not None:
                n = t.shape[dim] // tp
                t = t.narrow(dim, tp_index * n, n)
            if lead:
                leaf[i] = t
            else:
                leaf = t.clone() if dim is not None else t
            del t
        out[name] = leaf
    return out


def tp_step_fn(cfg):
    """The family's decode step, ``encdec_decode_step`` or ``lm_decode_step``
    (the same arguments)."""
    from repro_torch.models import encdec
    from repro_torch.models.decode import lm_decode_step

    return encdec.encdec_decode_step if cfg.family == "encdec" else lm_decode_step


def tp_cache(torch, cfg, params, b, s, device, dtype, tp, axes, frames=None):
    """A rank's empty decode cache of ``b`` sequences and ``s`` slots (k and
    v in ``dtype``, the recurrent states float32); the encoder-decoder's
    cross cache then filled by ``encdec_prefill`` from ``frames`` with
    ``dtype`` activations."""
    from repro_torch.models import encdec
    from repro_torch.models.decode import init_lm_cache

    if cfg.family != "encdec":
        return init_lm_cache(cfg, b, s, device=device, dtype=dtype, tp=tp, n_shards=tp)
    cache = encdec.init_encdec_cache(cfg, b, s, frames.shape[1], device=device, dtype=dtype,
                                     tp=tp, n_shards=tp)
    with torch.no_grad():
        return encdec.encdec_prefill(params, frames.to(device), cache, cfg, dtype, axes)


def tp_prompts(cfg, n: int) -> list:
    """The serve CLI's prompts (4 to 7 tokens) for ``n`` sequences."""
    from repro_torch.launch.serve import prompts

    return prompts(n, cfg.vocab)


def tp_stream(torch, step, params, cache, prompts, n_new, rows, device):
    """Every sequence's prompt fed token by token, then ``n_new`` greedy
    tokens, all sequences stepped together at positions 0, 1, ...; the rank
    decodes ``rows`` (``step`` returns their next tokens). Returns (each
    row's greedy tokens, each step's ms, host clock around the step and a
    sync, the cache, the tokens fed at each step)."""
    lens = [len(p) for p in prompts]
    outs = {b: [] for b in range(rows.start, rows.stop)}
    tok = [p[0] for p in prompts]
    times, fed = [], []
    for i in range(max(lens) + n_new - 1):
        fed.append(list(tok))
        t = torch.tensor(tok, dtype=torch.int64, device=device)
        pos = torch.full((len(prompts),), i, dtype=torch.int64, device=device)
        t0 = time.perf_counter()
        nxt, cache = step(params, cache, t, pos)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        for b, n in zip(outs, nxt.tolist()):
            if i >= lens[b] - 1 and len(outs[b]) < n_new:
                outs[b].append(n)
            if i + 1 < lens[b]:
                tok[b] = prompts[b][i + 1]
            elif outs[b]:
                tok[b] = outs[b][-1]
    return outs, times, cache, fed


def tp_forced_logits(torch, params, fed, cfg, cache, axes, rows, device):
    """The decode of ``fed`` (a step's tokens of every sequence, as
    :func:`tp_stream` returns them) at float32 activations on ``cache``:
    each step's logits of ``rows`` (vocab-local on a grid), stacked
    (steps, rows, V) on the host."""
    step = tp_step_fn(cfg)
    out = []
    with torch.no_grad():
        for i, tok in enumerate(fed):
            t = torch.tensor(tok, dtype=torch.int64, device=device)[rows]
            lg, cache = step(params, cache, t, torch.full_like(t, i), cfg, torch.float32,
                             axes=axes)
            out.append(lg.float().cpu())
    return torch.stack(out)


def tp_serve_rank(torch, grid, device, arch, layers, batch, max_seq, prompts, n_new,
                  fed, frames=None) -> dict:
    """One rank's TP decode of ``arch`` through ``build_serve_step``: its
    shard's checksums, the step-0 vocab-local logits, the greedy streams of
    its rows, ms a step, one step's host over card time, the model and data
    groups' calls a step and the peak; then the float32 decode of tp = 1's
    stream ``fed`` on a float32 cache of the same local shape, every step's
    vocab-local logits. The encoder-decoder's cross cache is filled from its
    rows of ``frames`` (``encdec_prefill``, timed) before each decode. Where
    the batch splits over the data replicas, first ``build_serve_step``'s
    prefill step on the prompts' shortest length (the encoder-decoder: on
    the frames): its vocab-local logits' shape, finiteness and ms."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.step import build_serve_step
    from repro_torch.models import encdec
    from repro_torch.parallel import collectives as coll

    cfg = tp_cfg(arch, layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    art = build_serve_step(cfg, grid, ShapeConfig("chip-smoke-serve", max_seq, batch, "decode"),
                           device=device)
    params = tp_serve_params(torch, cfg, grid.tp, grid.tp_index, device)
    step = tp_step_fn(cfg)
    pre = None
    if batch >= grid.n_dp:  # a prefill's rows are the batch's split over the replicas
        if frames is None:
            t = min(len(p) for p in prompts)
            batch_in = {"tokens": torch.tensor([p[:t] for p in prompts], device=device)}
        else:
            t, batch_in = frames.shape[1], {"frames": frames.to(device)}
        pre_art = build_serve_step(cfg, grid, ShapeConfig("chip-smoke-prefill", t, batch,
                                                          "prefill"), device=device)
        t0 = time.perf_counter()
        logits = pre_art.steps["prefill"](params, batch_in)
        torch.cuda.synchronize(device)
        pre = dict(ms=(time.perf_counter() - t0) * 1e3, shape=tuple(logits.shape),
                   finite=bool(torch.isfinite(logits).all()), t=t)
        del logits, batch_in
    prefill_ms = []

    def served_cache():  # the serve step's own cache, the cross cache filled
        cache = art.init_cache()
        if frames is None:
            return cache
        t0 = time.perf_counter()
        with torch.no_grad():
            cache = encdec.encdec_prefill(params, frames[art.rows].to(device), cache, cfg,
                                          axes=art.axes)
        torch.cuda.synchronize(device)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return cache

    first = torch.tensor([p[0] for p in prompts], device=device)[art.rows]
    with torch.no_grad():  # step 0 with float32 activations, and as served (bf16)
        logits0 = [step(params, served_cache(), first, torch.zeros_like(first), cfg,
                        getattr(torch, dt), axes=art.axes)[0].cpu()
                   for dt in STEP0_DTYPES]
    cache = served_cache()
    coll.reset_tp_counts()
    outs, times, cache, _ = tp_stream(torch, art.steps["decode"], params, cache, prompts, n_new,
                                      art.rows, device)
    calls = {k: v / len(times) for k, v in coll.tp_counts().items()}
    kv_key = next((k for k in cache if k.endswith("kv_pos")), None)
    # the first layer's positions, before the timed step
    kv_pos = None if kv_key is None else cache[kv_key][0].clone().cpu()
    t = torch.tensor([p[0] for p in prompts], device=device)
    host, card = host_card_ms(torch, lambda: art.steps["decode"](
        params, cache, t, torch.full_like(t, max_seq - 1)), reps=3)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    del cache
    rows = art.rows.stop - art.rows.start
    f32_cache = tp_cache(torch, cfg, params, rows, art.s_local, device, torch.float32, grid.tp,
                         art.axes, None if frames is None else frames[art.rows])
    forced = tp_forced_logits(torch, params, fed, cfg, f32_cache, art.axes, art.rows, device)
    out = dict(outs=outs, logits0=logits0, times=times, calls=calls, host=host, card=card,
               sums=params_checksums(torch, params), seq_sharded=art.seq_sharded,
               s_local=art.s_local, rows=(art.rows.start, art.rows.stop), kv_pos=kv_pos,
               peak=peak, forced=forced, prefill=pre, prefill_ms=prefill_ms)
    del params, f32_cache
    return out


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms on, for a checkpointed run: a
    resumed step can equal the uninterrupted one only if the step is
    deterministic (the memory-efficient SDPA backward otherwise splits the
    keys and sums dQ with atomics: granite's bf16 params differed run to run
    on an H100; warn_only keeps the split). Uninitialized memory is left
    unfilled: every buffer here is written before it is read."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def tp_ckpt_path(torch, ops, grid, device, tmp, path, straight):
    """One ``CKPT_PATHS`` path (``path``, its ``TP_PATHS`` entry) on this
    rank, deterministic: phase 23's uninterrupted run of ``CKPT_STEPS``
    steps (``straight``, its result), which saved after its second,
    resumed on a fresh grid (new process groups) for the last step; for
    the fused path, after it, the elastic resume onto the survivors' 1 x 2
    grid. The losses, the params' checksums after every step, the launches
    of both runs and the store's seconds and bytes."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.elastic import plan_after_failures

    _, arch, layers, _, opt, comp, wire, lr, fused, dtype = path
    cfg = tp_cfg(arch, layers)
    spec = specs.infer_param_specs(cfg, grid.tp)[2]
    shape = ShapeConfig("chip-smoke", TP_SEQ, 2 * grid.n_dp, "train")
    d = os.path.join(tmp, arch)
    res = dict(straight=dict(
        history=straight["history"], sums=straight["checksums"], launches=straight["launches"],
        bf16=straight["bf16"], stats=straight["stats"], n_leaves=straight["n_leaves"]))
    kw = dict(comp=comp, wire=wire, steps=CKPT_STEPS, lr=lr, fused=fused, opt=opt,
              dtype=dtype, device=device, ckpt_every=CKPT_STEPS - 1)
    g, sums = make_debug_mesh(*TP_GRID), []

    def on_step(i, p):
        sums.append(params_checksums(torch, p))
        torch.cuda.empty_cache()  # four ranks share the card

    gc.collect()
    torch.cuda.empty_cache()
    store = CheckpointStore(d, grid=g, specs=spec)
    ops.reset_launch_counts()
    params, hist = tp_train(torch, cfg, shape, n_workers=g.n_dp, grid=g, on_step=on_step,
                            ckpt=store, resume=True, **kw)
    store.close()
    res["resumed"] = dict(history=hist, sums=sums, launches=ops.launch_counts(),
                          bf16=ops.bf16_launch_counts(), stats=dict(store.stats),
                          n_leaves=len(params))
    del params
    if fused:  # the elastic resume 2 x 2 -> 1 x 2 of this checkpoint
        plan = plan_after_failures(dp=grid.n_dp, tp=grid.tp, failed_devices=ELASTIC_FAILED,
                                   global_batch=shape.global_batch, wire=wire)
        alive = [r for r in range(grid.n_dp * grid.tp)
                 if r // grid.tp not in plan.retired_replicas]
        small = make_debug_mesh(plan.n_dp, plan.tp, ranks=alive)
        res["plan"] = (plan.n_dp, plan.tp, plan.retired_replicas, plan.note)
        if small is not None:
            gc.collect()
            torch.cuda.empty_cache()
            store = CheckpointStore(d, grid=small, specs=spec)
            params, hist = tp_train(torch, cfg, dataclasses.replace(
                shape, global_batch=plan.global_batch), n_workers=small.n_dp, grid=small,
                ckpt=store, resume=True, **kw)
            store.close()
            res["elastic"] = dict(history=hist, stats=dict(store.stats))
            del params
    return res


def tp_ckpt_serve_rank(group, rank, device, tmp, fed, paths23):
    """One rank of phase 24 on the 2 x 2 grid: the checkpoint paths
    resumed from phase 23's runs (``paths23``, its results in ``TP_PATHS``
    order), then the TP decode of each ``SERVE_TP`` config and the
    sequence-sharded decode (``fed``: each one's tp = 1 token stream, by
    key)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh

    device = torch.device(device)
    torch.cuda.set_device(device)
    grid = make_debug_mesh(*TP_GRID)
    labels = [p[0] for p in TP_PATHS]
    with deterministic(torch):
        ckpt = [tp_ckpt_path(torch, ops, grid, device, tmp, TP_PATHS[labels.index(label)],
                             paths23[labels.index(label)]) for label in CKPT_PATHS]
    out = dict(grid=(grid.dp_index, grid.tp_index), ckpt=ckpt)
    for arch, layers in SERVE_TP:
        out[arch] = tp_serve_rank(torch, grid, device, arch, layers, SERVE_TP_BATCH,
                                  SERVE_TP_MAX_SEQ, tp_prompts(get_arch(arch), SERVE_TP_BATCH),
                                  SERVE_TP_NEW, fed[arch])
    sp_prompt = tp_prompts(get_arch("granite-8b"), 2)[1]  # 5 tokens
    out["sp"] = tp_serve_rank(torch, grid, device, "granite-8b", SP_LAYERS, 1, SP_MAX_SEQ,
                              [sp_prompt], SP_STEPS - len(sp_prompt) + 1, fed["sp"])
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp1_reference(torch, device, arch, layers, prompts, n_new, max_seq, frames=None) -> dict:
    """The tp = 1 decode of the same global params in this process: each
    sequence's greedy tokens and, at each of its greedy steps, its top-2
    gap over the step's largest |logit|; the step-0 logits; the checksums
    of each model index's slice of the params; the tokens fed at each step
    and their float32 decode on a float32 cache (every step's logits). The
    encoder-decoder's cross caches are filled from ``frames`` first."""
    from repro_torch.launch import specs
    from repro_torch.models.common import SINGLE, TpShard
    from repro_torch.models.decode import tp_greedy

    cfg = tp_cfg(arch, layers)
    params = tp_serve_params(torch, cfg, 2, None, device)
    step_fn = tp_step_fn(cfg)
    b = len(prompts)

    def cache_of(dtype):
        return tp_cache(torch, cfg, params, b, max_seq, device, dtype, 1, SINGLE, frames)

    first = torch.tensor([p[0] for p in prompts], device=device)
    with torch.no_grad():
        logits0 = [step_fn(params, cache_of(torch.bfloat16), first, torch.zeros_like(first),
                           cfg, getattr(torch, dt))[0].cpu() for dt in STEP0_DTYPES]
    cache = cache_of(torch.bfloat16)
    gaps = {i: [] for i in range(b)}

    def step(p, c, t, pos):
        with torch.no_grad():
            lg, c = step_fn(p, c, t, pos, cfg)
        lg = lg[:, :cfg.vocab]
        top = torch.topk(lg, 2, dim=-1).values
        gap = ((top[:, 0] - top[:, 1]) / lg.abs().amax(dim=-1)).tolist()
        for i in gaps:
            gaps[i].append(gap[i])
        return tp_greedy(lg), c

    outs, _, _, fed = tp_stream(torch, step, params, cache, prompts, n_new, slice(0, b), device)
    del cache
    forced = tp_forced_logits(torch, params, fed, cfg, cache_of(torch.float32), SINGLE,
                              slice(0, b), device)
    # each rank's shard as a slice of this tree (TpShard, whose inverse is
    # gather_shards), leaf by leaf: its checksums
    spec = specs.infer_param_specs(cfg, 2)[2]
    sums = [[c for k in sorted(params) for c in params_checksums(
        torch, {k: TpShard(specs=spec, index=i, size=2).take(k, params[k])})]
        for i in range(2)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lens = [len(p) for p in prompts]
    # the gap at each greedy token: the steps from the prompt's last on
    return dict(outs=outs, gaps={i: g[lens[i] - 1:lens[i] - 1 + n_new] for i, g in gaps.items()},
                logits0=logits0, sums=sums, fed=fed, forced=forced)


def tp_shard_checks(checks, label, res, tp1) -> None:
    """Every rank's shard its slice of the tp = 1 params (checksums), and
    each data replica's TP members' tokens equal."""
    tp = TP_GRID[1]
    checks.true(f"{label}: every rank's shard is its slice of the tp = 1 params (checksums)",
                all(r["sums"] == tp1["sums"][i % tp] for i, r in enumerate(res)))
    for d in range(TP_GRID[0]):
        members = res[d * tp:(d + 1) * tp]
        checks.true(f"{label}: data replica {d}'s {tp} TP members' tokens equal",
                    all(m["outs"] == members[0]["outs"] for m in members))


def tp_serve_checks(torch, checks, label, ranks, key, tp1, n_new, shard_slots=None) -> None:
    """Phase 24's serve checks of one config against its tp = 1 decode
    ``tp1`` (:func:`tp1_reference`); with ``shard_slots`` (the
    sequence-sharded decode) the forced stream's error is also printed for
    the steps past the first data replica's slots."""
    ref, gaps, ref0 = tp1["outs"], tp1["gaps"], tp1["logits0"]
    res = [r[key] for r in ranks]
    tp = TP_GRID[1]
    tp_shard_checks(checks, label, res, tp1)
    v = ref0[0].shape[-1] // tp
    for j, dt in enumerate(STEP0_DTYPES):
        scale = ref0[j].abs().max().item()
        errs = []
        for i, r in enumerate(res):
            want = ref0[j][slice(*r["rows"]), (i % tp) * v:(i % tp + 1) * v]
            errs.append((r["logits0"][j] - want).abs().max().item())
        what = (f"{label}: step-0 logits ({dt} activations, the served bf16 cache) of every "
                f"rank against the tp = 1 decode's, max abs err {max(errs):.4g} of the largest "
                f"|logit| {scale:.4g} ({max(errs) / scale:.3g})")
        if j == 0:
            checks.true(f"{what} <= {TP_LOGIT_TOL:g}", max(errs) <= TP_LOGIT_TOL * scale)
        else:
            print(f"  {what}: printed, not held", flush=True)
    # every step of tp = 1's stream, float32 activations and cache: each rank's
    # vocab-local logits of its rows against tp = 1's, over the row's largest
    want = tp1["forced"]
    rel = []
    for i, r in enumerate(res):
        rows, cols = slice(*r["rows"]), slice((i % tp) * v, (i % tp + 1) * v)
        scale = want[:, rows].abs().amax(-1, keepdim=True)
        rel.append(((r["forced"] - want[:, rows, cols]).abs() / scale).amax(-1).amax(-1))
    rel = torch.stack(rel).amax(0)  # (steps,): the largest over ranks and rows
    late = ("" if shard_slots is None else
            f"; steps {shard_slots}+ (positions on data replica 1's slots) "
            f"{rel[shard_slots:].max().item():.3g}")
    checks.true(f"{label}: all {len(rel)} steps of tp = 1's stream, float32 activations and "
                f"cache: every rank's logits against tp = 1's, largest error "
                f"{rel.max().item():.3g} of the row's largest |logit| (step 0 "
                f"{rel[0].item():.3g}{late}) <= {F32_LOGIT_TOL:g}",
                res[0]["forced"].shape[0] == len(rel) == len(tp1["fed"])
                and rel.max().item() <= F32_LOGIT_TOL)
    agreed = []
    for r in res[::tp]:
        for b, toks in r["outs"].items():
            n = next((j for j, g in enumerate(gaps[b]) if g < TP_LOGIT_TOL), n_new)
            agreed.append(n)
            checks.true(f"{label}: sequence {b}'s {len(toks)} greedy tokens equal the tp = 1 "
                        f"stream up to its first near tie (step {n} of {n_new})",
                        toks[:n] == ref[b][:n] and len(toks) == n_new)
    print(f"  {label}: tokens agree with tp = 1 for {agreed} greedy steps a sequence (up to "
          f"each one's first top-2 gap under {TP_LOGIT_TOL:g} of its largest |logit|)",
          flush=True)
    tp_serve_report(checks, label, res)


def tp_serve_report(checks, label, res) -> None:
    """Each rank's ms a decode step, host over card and peak, the prefill's
    ms where one ran (its vocab-local logits held finite, of the rank's
    rows), and the model and data groups' calls a step."""
    tp = TP_GRID[1]
    calls = res[0]["calls"]
    pre = [r["prefill"] for r in res if r["prefill"] is not None]
    if pre:
        want = [(r["rows"][1] - r["rows"][0], r["logits0"][0].shape[-1]) for r in res]
        checks.true(f"{label}: build_serve_step's prefill on every rank: vocab-local logits "
                    f"{pre[0]['shape']}, finite", len(pre) == len(res) and all(
                        p["finite"] and p["shape"] == w for p, w in zip(pre, want)))
    for i, r in enumerate(res):
        pre = r.get("prefill")
        if pre is not None:
            print(f"  {label}: rank {divmod(i, tp)}: build_serve_step's prefill of "
                  f"{pre['t']} positions {pre['ms']:.2f} ms (the first call), vocab-local "
                  f"logits {pre['shape']}", flush=True)
        if r.get("prefill_ms"):
            print(f"  {label}: rank {divmod(i, tp)}: encdec_prefill "
                  f"{[round(m, 2) for m in r['prefill_ms']]} ms", flush=True)
        print(f"  {label}: rank {divmod(i, tp)}: {len(r['times'])} decode steps, median "
              f"{statistics.median(r['times']):.2f} ms (min {min(r['times']):.2f}, max "
              f"{max(r['times']):.2f}; each synchronized); one step host {r['host']:.2f} ms, "
              f"card {r['card']:.2f} ms, host over card {r['host'] / r['card']:.2f}; peak "
              f"{r['peak']:.2f} GiB", flush=True)
    print(f"  {label}: a step: " + ", ".join(f"{k} {v:g}" for k, v in sorted(calls.items()))
          + " (4 processes time-sharing one card, gloo staging through the host)", flush=True)


def tp_split_serve_checks(torch, checks, label, ranks, key, tp1) -> None:
    """The serve checks of a config whose tp = 2 function is not its tp = 1
    one (``TP_SPLIT``): every rank's shard its slice of the tp = 1 params,
    the TP members' tokens equal, the step-0 logits and the float32 decode
    of tp = 1's stream finite; their gaps to tp = 1 printed, not held."""
    res = [r[key] for r in ranks]
    tp = TP_GRID[1]
    tp_shard_checks(checks, label, res, tp1)
    checks.true(f"{label}: every rank's step-0 logits ({', '.join(STEP0_DTYPES)} activations) "
                f"and its float32 decode of tp = 1's {len(tp1['fed'])} steps finite",
                all(bool(torch.isfinite(lg).all()) for r in res for lg in r["logits0"])
                and all(bool(torch.isfinite(r["forced"]).all()) for r in res))
    v = tp1["logits0"][0].shape[-1] // tp
    for j, dt in enumerate(STEP0_DTYPES):
        want = tp1["logits0"][j]
        err = max((r["logits0"][j] - want[slice(*r["rows"]), (i % tp) * v:(i % tp + 1) * v])
                  .abs().max().item() for i, r in enumerate(res))
        print(f"  {label}: step-0 logits ({dt} activations) against tp = 1's, max abs err "
              f"{err:.4g} of the largest |logit| {want.abs().max().item():.4g}: printed, not "
              "held (another function at tp = 2, ROADMAP's reference behaviours)", flush=True)
    want = tp1["forced"]
    rel = max(((r["forced"] - want[:, slice(*r["rows"]), (i % tp) * v:(i % tp + 1) * v]).abs()
               / want[:, slice(*r["rows"])].abs().amax(-1, keepdim=True)).max().item()
              for i, r in enumerate(res))
    agreed = [next((j for j, (a, b) in enumerate(zip(toks, tp1["outs"][b_])) if a != b),
                   len(toks)) for r in res[::tp] for b_, toks in r["outs"].items()]
    print(f"  {label}: tp = 1's stream decoded on the grid in float32: largest gap "
          f"{rel:.3g} of the row's largest |logit|; greedy tokens equal to tp = 1's for "
          f"{agreed} steps a sequence (printed, not held)", flush=True)
    tp_serve_report(checks, label, res)


def tp_ckpt_serve_references(torch, device):
    """Phase 24's tp = 1 references, made before the spawn (the ranks decode
    their float32 streams): ``(serve paths, {key: tp1_reference})``."""
    from repro_torch.configs.base import get_arch

    t0 = time.perf_counter()
    sp_prompt = tp_prompts(get_arch("granite-8b"), 2)[1]  # 5 tokens
    serve = [(f"tp-serve {arch} ({layers} L)", arch, arch, layers,
              tp_prompts(get_arch(arch), SERVE_TP_BATCH), SERVE_TP_NEW, SERVE_TP_MAX_SEQ)
             for arch, layers in SERVE_TP]
    serve.append((f"tp-serve-sp granite-8b ({SP_LAYERS} L)", "sp", "granite-8b", SP_LAYERS,
                  [sp_prompt], SP_STEPS - len(sp_prompt) + 1, SP_MAX_SEQ))
    tp1 = {key: tp1_reference(torch, device, arch, layers, prompts, n_new, max_seq)
           for _, key, arch, layers, prompts, n_new, max_seq in serve}
    print(f"tp-serve: the tp = 1 references {time.perf_counter() - t0:.1f}s", flush=True)
    return serve, tp1


def tp_ckpt_serve_checks(torch, ops, checks, ranks, serve, tp1) -> collections.Counter:
    """Phase 24's checks on each rank's :func:`tp_ckpt_serve_rank` result:
    the checkpoint paths, the elastic resume and the TP decode against the
    tp = 1 references. Returns every rank's launch counts."""
    launches = collections.Counter()
    n_dp, tp = TP_GRID
    checks.true(f"tp-ckpt-serve: ranks on grid places {[r['grid'] for r in ranks]}",
                [r["grid"] for r in ranks] == [divmod(i, tp) for i in range(n_dp * tp)])
    paths = {p[0]: p for p in TP_PATHS}
    for pi, path in enumerate(CKPT_PATHS):
        _, arch, layers, _, opt, comp, wire, lr, fused, dtype = paths[path]
        label = f"tp-ckpt {path.split(' ', 1)[1]}"
        res = [r["ckpt"][pi] for r in ranks]
        n_leaves = res[0]["straight"]["n_leaves"]
        want3, _, want3_bf16 = expected_launches(
            ops, n_leaves, CKPT_STEPS, opt, comp, wire, fused=fused, microbatches=1,
            n_local=1, param_dtype=dtype, n_workers=n_dp)
        want1, want1_bf16 = (
            {k: a[k] - b[k] for k in a} for a, b in zip(
                expected_launches(ops, n_leaves, 2, opt, comp, wire, fused=fused,
                                  microbatches=1, n_local=1, param_dtype=dtype,
                                  n_workers=n_dp)[::2],
                expected_launches(ops, n_leaves, 1, opt, comp, wire, fused=fused,
                                  microbatches=1, n_local=1, param_dtype=dtype,
                                  n_workers=n_dp)[::2]))
        for r, (dp_i, tp_i) in zip(res, (divmod(i, tp) for i in range(n_dp * tp))):
            s, q = r["straight"], r["resumed"]
            last = s["history"][-1]
            checks.true(f"{label}: rank ({dp_i}, {tp_i}) resumed step {CKPT_STEPS - 1}: loss "
                        f"{q['history'][-1]['loss']!r} == uninterrupted {last['loss']!r}, max_int "
                        f"{q['history'][-1]['max_int']:g} == {last['max_int']:g}",
                        len(q["history"]) == 1 and q["history"][0]["step"] == CKPT_STEPS - 1
                        and q["history"][0]["loss"] == last["loss"]
                        and q["history"][0]["max_int"] == last["max_int"])
            checks.true(f"{label}: rank ({dp_i}, {tp_i}) params after the resumed step "
                        f"bit-identical to the uninterrupted run's ({len(s['sums'][-1])} "
                        f"checksums)", q["sums"][-1] == s["sums"][-1])
            for run, want, want_b in (("straight", want3, want3_bf16),
                                      ("resumed", want1, want1_bf16)):
                ok = all(r[run]["launches"][k] == want[k] and r[run]["bf16"][k] == want_b[k]
                         for k in want)
                checks.true(f"{label}: rank ({dp_i}, {tp_i}) {run} launches "
                            f"{r[run]['launches']} (expected {want})", ok)
            # the uninterrupted run's launches are phase 23's
            launches.update(r["resumed"]["launches"])
        st, rs = res[0]["straight"]["stats"], [r["resumed"]["stats"] for r in res]
        checks.true(f"{label}: the writer's {st.get('bytes', 0):.0f} bytes saved and every "
                    f"rank restored", st.get("bytes", 0) > 0 and all("restore_s" in s for s in rs))
        print(f"  {label}: checkpoint of {st['bytes']:.0f} bytes (the global layout): "
              f"{st['host_s']:.2f} s to host (the model and row gathers included), "
              f"{st['disk_s']:.2f} s to disk (written in the background), restore "
              f"{max(s['restore_s'] for s in rs):.2f} s (the slowest rank); losses "
              f"{[h['loss'] for h in res[0]['straight']['history']]!r}; step ms "
              f"{[round(h['ms'], 1) for h in res[0]['straight']['history']]}", flush=True)
        if "plan" in res[0]:
            n_dp2, tp2, retired, note = res[0]["plan"]
            print(f"  {label}: elastic re-plan after losing rank {ELASTIC_FAILED}: "
                  f"{n_dp2} x {tp2} grid, retired data replicas {retired}; {note}", flush=True)
            el = [r.get("elastic") for r in res]
            alive = [e for e in el if e is not None]
            checks.true(f"{label}: elastic resume {n_dp} x {tp} -> {n_dp2} x {tp2} on "
                        f"{len(alive)} survivors: step {CKPT_STEPS - 1} losses "
                        f"{[e['history'][-1]['loss'] for e in alive]!r} finite and equal",
                        n_dp2 == 1 and tp2 == tp and len(alive) == tp
                        and all(math.isfinite(e["history"][-1]["loss"]) for e in alive)
                        and len({e["history"][-1]["loss"] for e in alive}) == 1)
            print(f"  {label}: elastic restore {max(e['stats']['restore_s'] for e in alive):.2f}"
                  f" s", flush=True)
    for label, key, _, _, _, n_new, max_seq in serve:
        tp_serve_checks(torch, checks, label, ranks, key, tp1[key], n_new,
                        shard_slots=max_seq // n_dp if key == "sp" else None)
    for i, r in enumerate(ranks):
        sp = r["sp"]
        shard = i // tp
        want = list(range(shard * SP_MAX_SEQ // n_dp,
                          min(SP_STEPS, (shard + 1) * SP_MAX_SEQ // n_dp)))
        got = sorted(p for p in sp["kv_pos"][0].tolist() if p < 2**30)
        checks.true(f"tp-serve-sp: rank {divmod(i, tp)} sequence-sharded, {sp['s_local']} slots, "
                    f"holds positions {got[0] if got else None}..{got[-1] if got else None}",
                    sp["seq_sharded"] and sp["s_local"] == SP_MAX_SEQ // n_dp and got == want)
    return launches


# phase 25: the hybrid, ssm and encoder-decoder decode at tp = 2 on the 2 x 2
# grid, with phase 24's traffic: (arch, layers): zamba2's 54 layers cut to 18
# (two blocks of 9, so the shared block's KV cache is used twice), xlstm at
# its full 12, seamless at its full 12 + 12 on ENCDEC_FRAMES frames a sequence
SERVE_TP_RECURRENT = (("zamba2-2.7b", 18), ("xlstm-125m", 12), ("seamless-m4t-medium", 12))
# the sequence-sharded decode (global batch 1, SP_MAX_SEQ slots split over the
# data replicas, SP_STEPS tokens): zamba2 at one block of 9 layers, seamless at
# 2 + 2 on ENCDEC_CHECK_FRAMES frames
SP_RECURRENT = (("zamba2-2.7b", 9), ("seamless-m4t-medium", 2))
# the smoke grids' float32 decode on the card against the CPU
SMOKE_DECODE_STEPS, SMOKE_DECODE_TOL = 8, 1e-4
SMOKE_DECODE_ARCHS = ("zamba2-2.7b", "xlstm-125m")


def tp_frames(torch, cfg, n: int, t: int):
    """``n`` sequences of ``t`` frames of the encoder-decoder's frontend
    width, on the host (the same on every rank and at tp = 1)."""
    return torch.randn(n, t, cfg.frontend_dim, generator=torch.Generator().manual_seed(1))


def tp_decode_smoke_card_cpu(torch, grid, device) -> dict:
    """Each ``SMOKE_DECODE_ARCHS`` smoke config's decode at tp = 2 on the
    grid, float32 activations and cache, ``SMOKE_DECODE_STEPS``
    teacher-forced steps of a global batch of 4 (this rank's rows), on the
    card and then on the CPU (the same gloo groups) from the same shard of
    the same global params: {arch: (largest |card - CPU| logit, largest
    |CPU logit|, card logits finite)}."""
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.launch import specs
    from repro_torch.models.common import Axes
    from repro_torch.models.decode import init_lm_cache, lm_decode_step
    from repro_torch.models.transformer import init_lm_params

    axes = Axes(group=grid.model_group, tp_size=grid.tp, tp_index=grid.tp_index)
    rows = slice(2 * grid.dp_index, 2 * grid.dp_index + 2)
    out = {}
    for arch in SMOKE_DECODE_ARCHS:
        cfg = smoke_config(get_arch(arch))
        shard = specs.tp_shard(cfg, grid.tp, grid.tp_index).tree(init_lm_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu", tp=grid.tp))
        tokens = torch.randint(0, cfg.vocab, (SMOKE_DECODE_STEPS, 4),
                               generator=torch.Generator().manual_seed(2))
        runs = []
        for d in (device, torch.device("cpu")):
            params = {k: v.to(d) for k, v in shard.items()}
            cache = init_lm_cache(cfg, 2, SMOKE_DECODE_STEPS, device=d, dtype=torch.float32,
                                  tp=grid.tp, n_shards=grid.tp)
            logits = []
            with torch.no_grad():
                for i in range(SMOKE_DECODE_STEPS):
                    lg, cache = lm_decode_step(params, cache, tokens[i, rows].to(d),
                                               torch.full((2,), i, device=d), cfg,
                                               torch.float32, axes)
                    logits.append(lg.cpu())
            runs.append(torch.stack(logits))
        card, cpu = runs
        out[arch] = ((card - cpu).abs().max().item(), cpu.abs().max().item(),
                     bool(torch.isfinite(card).all()))
    return out


def tp_recurrent_serve_rank(group, rank, device, fed, frames):
    """One rank of phase 25 on the 2 x 2 grid: the TP decode of each
    ``SERVE_TP_RECURRENT`` config and each ``SP_RECURRENT`` sequence-sharded
    one (``fed``: each one's tp = 1 token stream, ``frames``: the
    encoder-decoder's, by key), its kernel launches over them, then the
    smoke grids' decode card against CPU."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh

    device = torch.device(device)
    torch.cuda.set_device(device)
    grid = make_debug_mesh(*TP_GRID)
    out = dict(grid=(grid.dp_index, grid.tp_index))
    ops.reset_launch_counts()
    for arch, layers in SERVE_TP_RECURRENT:
        out[arch] = tp_serve_rank(torch, grid, device, arch, layers, SERVE_TP_BATCH,
                                  SERVE_TP_MAX_SEQ, tp_prompts(get_arch(arch), SERVE_TP_BATCH),
                                  SERVE_TP_NEW, fed[arch], frames=frames.get(arch))
    for arch, layers in SP_RECURRENT:
        key = f"sp {arch}"
        prompt = tp_prompts(get_arch(arch), 2)[1]
        out[key] = tp_serve_rank(torch, grid, device, arch, layers, 1, SP_MAX_SEQ, [prompt],
                                 SP_STEPS - len(prompt) + 1, fed[key], frames=frames.get(key))
    out["launches"] = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["smoke"] = tp_decode_smoke_card_cpu(torch, grid, device)
    out["smoke_s"] = time.perf_counter() - t0
    return out


def tp_recurrent_references(torch, device):
    """Phase 25's tp = 1 references, made before the spawn: ``(serve paths,
    the encoder-decoder's frames by key, {key: tp1_reference})``."""
    from repro_torch.configs.base import get_arch

    t0 = time.perf_counter()
    serve, frames = [], {}
    for arch, layers in SERVE_TP_RECURRENT:
        cfg = get_arch(arch)
        enc = cfg.family == "encdec"
        depth = f"{layers} + {layers} L, {ENCDEC_FRAMES} frames" if enc else f"{layers} L"
        serve.append((f"tp-serve {arch} ({depth})", arch, arch, layers,
                      tp_prompts(cfg, SERVE_TP_BATCH), SERVE_TP_NEW, SERVE_TP_MAX_SEQ))
        if enc:
            frames[arch] = tp_frames(torch, cfg, SERVE_TP_BATCH, ENCDEC_FRAMES)
    for arch, layers in SP_RECURRENT:
        cfg, key = get_arch(arch), f"sp {arch}"
        enc = cfg.family == "encdec"
        depth = (f"{layers} + {layers} L, {ENCDEC_CHECK_FRAMES} frames" if enc
                 else f"{layers} L")
        prompt = tp_prompts(cfg, 2)[1]
        serve.append((f"tp-serve-sp {arch} ({depth})", key, arch, layers, [prompt],
                      SP_STEPS - len(prompt) + 1, SP_MAX_SEQ))
        if enc:
            frames[key] = tp_frames(torch, cfg, 1, ENCDEC_CHECK_FRAMES)
    tp1 = {key: tp1_reference(torch, device, arch, layers, prompts, n_new, max_seq,
                              frames=frames.get(key))
           for _, key, arch, layers, prompts, n_new, max_seq in serve}
    print(f"tp-serve-recurrent: the tp = 1 references {time.perf_counter() - t0:.1f}s",
          flush=True)
    return serve, frames, tp1


def tp_recurrent_checks(torch, checks, ranks, serve, tp1) -> collections.Counter:
    """Phase 25's checks on each rank's :func:`tp_recurrent_serve_rank`
    result against the tp = 1 references. Returns every rank's launch
    counts over the serve paths (none of ours)."""
    n_dp, tp = TP_GRID
    print(f"tp-serve-recurrent: the smoke grids {max(r['smoke_s'] for r in ranks):.1f}s",
          flush=True)
    checks.true(f"tp-serve-recurrent: ranks on grid places {[r['grid'] for r in ranks]}",
                [r["grid"] for r in ranks] == [divmod(i, tp) for i in range(n_dp * tp)])
    for label, key, arch, _, _, n_new, max_seq in serve:
        if arch in TP_SPLIT:
            tp_split_serve_checks(torch, checks, label, ranks, key, tp1[key])
        else:
            tp_serve_checks(torch, checks, label, ranks, key, tp1[key], n_new,
                            shard_slots=max_seq // n_dp if key.startswith("sp ") else None)
    for arch, _ in SP_RECURRENT:
        key = f"sp {arch}"
        for i, r in enumerate(ranks):
            sp = r[key]
            shard = i // tp
            want = list(range(shard * SP_MAX_SEQ // n_dp,
                              min(SP_STEPS, (shard + 1) * SP_MAX_SEQ // n_dp)))
            got = sorted(p for p in sp["kv_pos"].flatten().tolist() if p < 2**30)
            checks.true(f"tp-serve-sp {arch}: rank {divmod(i, tp)} sequence-sharded, "
                        f"{sp['s_local']} slots, its first attention's cache holds positions "
                        f"{got[0] if got else None}..{got[-1] if got else None}",
                        sp["seq_sharded"] and sp["s_local"] == SP_MAX_SEQ // n_dp
                        and got == want)
    for arch in SMOKE_DECODE_ARCHS:
        errs = [r["smoke"][arch] for r in ranks]
        worst = max(e / scale for e, scale, _ in errs)
        checks.true(f"tp-serve-recurrent: {arch} smoke grid, {SMOKE_DECODE_STEPS} float32 "
                    f"decode steps at tp = 2, card against CPU on every rank: logits within "
                    f"{worst:.3g} of the largest |logit| <= {SMOKE_DECODE_TOL:g}, finite",
                    worst <= SMOKE_DECODE_TOL and all(f for _, _, f in errs))
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["launches"])
    checks.true(f"tp-serve-recurrent: the decode paths launch no kernel of ours "
                f"({dict(launches)})", not any(launches.values()))
    return launches


# phase 26: the paper's other compressors on the 2 x 2 grid (ROADMAP item
# 12.6d): xlstm-125m at published width, 6 layers (two (m, m, s) blocks, so
# every stacked leaf has PowerSGD's rank of 2 rows), float32, ZeRO-1 SGD, 3
# steps a path: (label, compressor, wire, make_compressor arguments)
TP_BASELINE_ARCH, TP_BASELINE_LAYERS = "xlstm-125m", 6
TP_BASELINE_SEQ, TP_BASELINE_STEPS, TP_BASELINE_LR = 512, 3, 0.3
# PowerSGD's default min_compress_size refuses this grid (the reference fails
# to build it): the sLSTM bias layers/s/cell/b is 6,144 elements globally and
# 3,072 a shard; at 3,072 every leaf the default compresses globally is
# compressed on its shard too
TP_POWERSGD_REFUSED, TP_POWERSGD_MIN = "layers/s/cell/b", 3072
TP_BASELINE_PATHS = (
    ("tp-baseline none", "none", None, {}),
    ("tp-baseline allgather_sgd", "allgather_sgd", None, {}),
    ("tp-baseline qsgd", "qsgd", None, {}),
    ("tp-baseline qsgd-packed8", "qsgd", "packed8", {}),
    ("tp-baseline natsgd", "natsgd", None, {}),
    ("tp-baseline powersgd", "powersgd", None, {"min_compress_size": TP_POWERSGD_MIN}),
    ("tp-baseline signsgd", "signsgd", None, {}),
    ("tp-baseline topk", "topk", None, {}),
    ("tp-baseline intsgd-topk8", "intsgd", "topk8:1048576", {}),
)
TP_BASELINE_STEP0_RTOL = 1e-5
# the smoke config on the grid, card against CPU: (compressor, arguments);
# both draw their uniforms from the counter PRNG, the same on the card and
# the CPU
TP_BASELINE_SMOKE = (("powersgd", {"min_compress_size": 256}), ("qsgd", {}))
TP_BASELINE_SMOKE_TOL = 1e-3


def tp_baseline_smoke(torch, grid, device) -> dict:
    """Each ``TP_BASELINE_SMOKE`` compressor on xlstm's smoke config at
    ``TP_BASELINE_LAYERS`` layers, ``TP_BASELINE_STEPS`` steps of
    ``build_train_step`` on the grid, on the card and then on the CPU (the
    same gloo groups), from the same params (the global draw on the CPU,
    this rank's shard), batches and seeds: {compressor: (card losses, CPU
    losses)}."""
    from repro_torch.configs.base import ShapeConfig, get_arch, smoke_config
    from repro_torch.core.compressor import leaf_seeds, make_compressor
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch import specs
    from repro_torch.launch.step import build_init_state, build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.optim.schedules import constant, warmup_wrap

    cfg = dataclasses.replace(smoke_config(get_arch(TP_BASELINE_ARCH)),
                              n_layers=TP_BASELINE_LAYERS)
    shape = ShapeConfig("chip-smoke-tp", TP_SMOKE_SEQ, 2 * grid.n_dp, "train")
    params0 = specs.tp_shard(cfg, grid.tp, grid.tp_index).tree(init_lm_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu", tp=grid.tp))
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    out = {}
    for name, kw in TP_BASELINE_SMOKE:
        runs = []
        for dev in (device, torch.device("cpu")):
            comp, base_opt = make_compressor(name, **kw), OPTIMIZERS["sgd"]()
            art = build_train_step(
                cfg, shape, n_workers=grid.n_dp, compressor=comp, base_opt=base_opt,
                lr_schedule=warmup_wrap(constant(TP_BASELINE_LR), 5),
                param_dtype=torch.float32, clip_norm=1.0, device=dev, grid=grid)
            params = {k: v.to(dev) for k, v in params0.items()}
            opt_state, comp_state = build_init_state(params, n_workers=grid.n_dp,
                                                     compressor=comp, base_opt=base_opt,
                                                     grid=grid)
            gen = torch.Generator().manual_seed(0)
            losses = []
            for i in range(TP_BASELINE_STEPS):
                seeds = leaf_seeds(gen, grid.n_dp, len(art.layout.names), dev)
                fn = art.steps["exact"] if i == 0 else art.steps["compressed"]
                params, opt_state, comp_state, loss, _ = fn(
                    params, opt_state, comp_state, i,
                    {k: v.to(dev) for k, v in data.batch(i, 0).items()}, seeds)
                losses.append(float(loss))
            runs.append(losses)
            del params, opt_state, comp_state
        out[name] = tuple(runs)
    torch.cuda.empty_cache()
    return out


def tp_baselines_rank(group, rank, device):
    """One rank of phase 26: each ``TP_BASELINE_PATHS`` path through
    ``train_loop`` on this rank's shard of the grid, on the shared card;
    per path the history, the checksums of the params and of the
    replicated leaves after every step, the kernel launches, the data
    group's calls and the peak memory; then the smoke config card against
    CPU."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compressor import make_compressor
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh

    device = torch.device(device)
    torch.cuda.set_device(device)
    grid = make_debug_mesh(*TP_GRID)
    cfg = tp_cfg(TP_BASELINE_ARCH, TP_BASELINE_LAYERS)
    rep = [k for k, d in specs.infer_param_specs(cfg, grid.tp)[2].items() if d is None]
    shape = ShapeConfig("chip-smoke", TP_BASELINE_SEQ, 2 * TP_GRID[0], "train")
    calls = collections.Counter()
    # each call counted by name, with its group's place among its arguments
    group_arg = {"all_reduce": 2, "all_gather": 2, "all_to_all_single": 4}
    wrapped = {name: getattr(dist, name) for name in group_arg}

    def counting(name):
        fn, at = wrapped[name], group_arg[name]

        def call(*a, **kw):
            if (kw["group"] if "group" in kw else a[at] if len(a) > at else None) is \
                    grid.data_group:
                calls[name] += 1
            return fn(*a, **kw)

        return call

    out = []
    for name in wrapped:
        setattr(dist, name, counting(name))
    try:
        for label, comp, wire, kw in TP_BASELINE_PATHS:
            sums, rep_sums, seen = [], [], []

            def on_step(i, p):
                seen.append(sum(calls.values()))  # before the checksums' own calls
                sums.append(params_checksums(torch, p))
                rep_sums.append(params_checksums(torch, {k: p[k] for k in rep}))
                torch.cuda.empty_cache()  # four ranks share the card

            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            calls.clear()
            params, history = tp_train(
                torch, cfg, shape, n_workers=grid.n_dp, comp=comp, wire=wire,
                steps=TP_BASELINE_STEPS, lr=TP_BASELINE_LR, fused=False, opt="sgd",
                dtype="float32", device=device, grid=grid, on_step=on_step,
                compressor=make_compressor(comp, **kw) if kw else None)
            out.append(dict(history=history, checksums=sums, rep_sums=rep_sums,
                            n_leaves=len(params), launches=ops.launch_counts(),
                            bf16=ops.bf16_launch_counts(), calls=dict(calls),
                            step_calls=[b - a for a, b in zip([0] + seen, seen)],
                            grid=(grid.dp_index, grid.tp_index),
                            peak=torch.cuda.max_memory_allocated() / 2**30,
                            reserved=torch.cuda.max_memory_reserved() / 2**30))
            del params
    finally:
        for name, fn in wrapped.items():
            setattr(dist, name, fn)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    smoke = tp_baseline_smoke(torch, grid, device)
    return dict(paths=out, smoke=smoke, smoke_s=time.perf_counter() - t0)


def tp_baselines_refusal(torch, checks) -> None:
    """PowerSGD at its default min_compress_size on phase 26's grid raises
    at build, naming the leaf the reference fails on."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compressor import make_compressor
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.step import build_train_step
    from repro_torch.launch.train import OPTIMIZERS
    from repro_torch.optim.schedules import constant

    grid = Grid(n_dp=TP_GRID[0], tp=TP_GRID[1], dp_index=0, tp_index=0, data_group=None,
                model_group=None)
    try:
        build_train_step(tp_cfg(TP_BASELINE_ARCH, TP_BASELINE_LAYERS),
                         ShapeConfig("chip-smoke", TP_BASELINE_SEQ, 2 * TP_GRID[0], "train"),
                         n_workers=TP_GRID[0], compressor=make_compressor("powersgd"),
                         base_opt=OPTIMIZERS["sgd"](), lr_schedule=constant(0.1),
                         device="cpu", grid=grid)
        msg = None
    except NotImplementedError as e:
        msg = str(e)
    checks.true(f"tp-baseline powersgd: the default min_compress_size refuses the grid "
                f"({msg})", msg is not None and repr(TP_POWERSGD_REFUSED) in msg)


def tp_baselines_checks(torch, ops, checks, ranks) -> collections.Counter:
    """Phase 26's checks on each rank's :func:`tp_baselines_rank` result.
    Returns every rank's launch counts."""
    launches = collections.Counter()
    n_dp, tp = TP_GRID
    steps = TP_BASELINE_STEPS
    step0 = {}
    for pi, (label, comp, wire, kw) in enumerate(TP_BASELINE_PATHS):
        res = [r["paths"][pi] for r in ranks]
        checks.true(f"{label}: ranks on grid places {[r['grid'] for r in res]}",
                    [r["grid"] for r in res] == [divmod(i, tp) for i in range(n_dp * tp)])
        hist = res[0]["history"]
        step0[label] = hist[0]["loss"]
        for r in res:
            checks.true(f"{label}: rank {r['grid']} losses finite "
                        f"({[h['loss'] for h in r['history']]!r})",
                        all(math.isfinite(h["loss"]) for h in r["history"]))
        lim_sum = wire_limits(comp, wire, n_dp, 1)[1]
        checks.true(f"{label}: max_int <= {lim_sum} on every compressed step, every rank "
                    f"({[h['max_int'] for h in hist[1:]]})",
                    all(h["max_int"] <= lim_sum and (h["max_int"] > 0) == (lim_sum > 0)
                        for r in res for h in r["history"][1:]))
        for step in range(steps):
            for t in range(tp):
                sums = [res[d * tp + t]["checksums"][step] for d in range(n_dp)]
                checks.true(f"{label}: step {step}: the {n_dp} dp replicas of model shard {t} "
                            f"bit-identical ({len(sums[0])} leaves' checksums)",
                            all(x == sums[0] for x in sums))
            for d in range(n_dp):
                sums = [res[d * tp + t]["rep_sums"][step] for t in range(tp)]
                checks.true(f"{label}: step {step}: data replica {d}'s {len(sums[0])} "
                            f"replicated leaves bit-identical across the model group",
                            all(x == sums[0] for x in sums))
        want, _, want_bf16 = expected_launches(
            ops, res[0]["n_leaves"], steps, "sgd", comp, wire, fused=False, microbatches=1,
            n_local=1, param_dtype="float32", n_workers=n_dp)
        for r in res:
            ok = all(r["launches"][k] == want[k] and r["bf16"][k] == want_bf16[k]
                     for k in want)
            checks.true(f"{label}: rank {r['grid']} launches {r['launches']} (expected "
                        f"{want})", ok)
            launches.update(r["launches"])
        for r in res:
            print(f"  {label}: rank {r['grid']}: step ms "
                  f"{[round(h['ms'], 1) for h in r['history']]}, peak {r['peak']:.2f} GiB "
                  f"({r['reserved']:.2f} reserved), the data group's calls by step "
                  f"{r['step_calls']} ({dict(sorted(r['calls'].items()))} in all) (4 processes "
                  f"time-sharing one card, gloo staging through the host: not a transport "
                  f"speed)", flush=True)
        print(f"  {label}: losses {[h['loss'] for h in hist]!r}, max_int "
              f"{[h['max_int'] for h in hist]}", flush=True)
    first = next(iter(step0.values()))
    worst = max(abs(v - first) / abs(first) for v in step0.values())
    checks.true(f"tp-baseline: the {len(step0)} paths' step-0 losses (the exact step) within "
                f"{worst:.3g} <= {TP_BASELINE_STEP0_RTOL:g} relative of each other",
                worst <= TP_BASELINE_STEP0_RTOL)
    for name, _ in TP_BASELINE_SMOKE:
        for r, (dp_i, tp_i) in zip(ranks, (divmod(i, tp) for i in range(n_dp * tp))):
            card, cpu = r["smoke"][name]
            gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
            checks.true(f"tp-baseline smoke {TP_BASELINE_ARCH} ({TP_BASELINE_LAYERS} L) {name}: "
                        f"rank ({dp_i}, {tp_i}) losses on the card {card!r}, on the CPU "
                        f"{cpu!r}, largest relative gap {gap:.3g} < {TP_BASELINE_SMOKE_TOL:g}",
                        all(math.isfinite(x) for x in card) and gap < TP_BASELINE_SMOKE_TOL)
    print(f"tp-baseline: the smoke grids {max(r['smoke_s'] for r in ranks):.1f}s", flush=True)
    return launches


# phase 27: pipeline parallelism on the flat group of four ranks as the stage
# group (ROADMAP item 7): granite-8b's decoder layer at published width
PP_ARCH, PP_LAYERS, PP_STAGES, PP_MICRO, PP_SEQ = "granite-8b", 8, 4, 6, 512
PP_SEED = 2700
PP_RTOL, PP_ATOL = 1e-4, 1e-5  # the last stage's output (the reference test's)
# a gradient leaf's largest |error| over its largest |gradient|: float32 sums
# of 3,072 tokens' terms in another order (the SDPA backward's atomic dQ sums)
# differ by ~1e-7 of the leaf's scale; a microbatch or a layer missed or
# counted twice moves it by O(1)
PP_GRAD_TOL = 1e-4


def pp_layer_fn(torch, cfg, device):
    """The port's decoder layer at SINGLE axes on (1, PP_SEQ, d) states."""
    from repro_torch.models.common import SINGLE
    from repro_torch.models.transformer import _layer, resolve_dims

    dims = resolve_dims(cfg, 1, 1)
    positions = torch.arange(PP_SEQ, device=device).expand(1, PP_SEQ)
    return lambda lp, h: _layer(lp, h, positions, cfg, dims, SINGLE)


def pp_layer(torch, cfg, layer, device):
    """Layer ``layer``'s float32 params, drawn on the card from its own seed
    (so a rank draws its stage's layers alone): norms ones, matrices
    N(0, 1/fan_in)."""
    from repro_torch.launch import specs

    gen = torch.Generator(device=device).manual_seed(PP_SEED + layer)
    out = {}
    for name, shape in sorted(specs.param_shapes(cfg).items()):
        if not name.startswith("layers/"):
            continue
        shape = shape[1:]
        if len(shape) == 1:
            out[name[len("layers/"):]] = torch.ones(shape, device=device)
        else:
            out[name[len("layers/"):]] = torch.randn(
                shape, generator=gen, device=device) / math.sqrt(shape[0])
    return out


def pp_inputs(torch, cfg, device):
    gen = torch.Generator(device=device).manual_seed(PP_SEED - 1)
    return torch.randn((PP_MICRO, 1, PP_SEQ, cfg.d_model), generator=gen, device=device)


def pp_references(torch, device, tmp):
    """Phase 27's reference on the card: the sequential 8-layer stack a
    microbatch at a time, the gradients of Σ out² summed last microbatch
    first (the pipeline's backward order); each stage's gradient rows, the
    outputs and the input gradient written to ``tmp`` for the ranks, the
    card freed."""
    from repro_torch.configs.base import get_arch

    cfg = get_arch(PP_ARCH)
    layer_fn = pp_layer_fn(torch, cfg, device)
    layers = [pp_layer(torch, cfg, i, device) for i in range(PP_LAYERS)]
    for lp in layers:
        for v in lp.values():
            v.requires_grad_(True)
    x = pp_inputs(torch, cfg, device)
    outs, g_x, grads = [None] * PP_MICRO, torch.zeros_like(x), None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in reversed(range(PP_MICRO)):
        xm = x[m].clone().requires_grad_(True)
        h = xm
        for lp in layers:
            h = layer_fn(lp, h)
        outs[m] = h.detach()
        leaves = [v for lp in layers for v in lp.values()]
        gs = torch.autograd.grad((h ** 2).sum(), [xm, *leaves])
        g_x[m] = gs[0]
        grads = list(gs[1:]) if grads is None else [a.add_(b) for a, b in zip(grads, gs[1:])]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    names = list(layers[0])
    per = PP_LAYERS // PP_STAGES
    for s in range(PP_STAGES):
        rows = {k: torch.stack([grads[(s * per + j) * len(names) + i] for j in range(per)]).cpu()
                for i, k in enumerate(names)}
        ref = {"grads": rows}
        if s == 0:
            ref["g_x"] = g_x.cpu()
        if s == PP_STAGES - 1:
            ref["out"] = torch.stack(outs).cpu()
        torch.save(ref, os.path.join(tmp, f"pp_stage{s}.pt"))
    print(f"pipeline: the sequential reference ({PP_LAYERS} layers, {PP_MICRO} microbatches, "
          f"forward and backward) {seq_s:.2f}s on the card", flush=True)
    del layers, x, outs, g_x, grads, leaves, gs, h, xm
    gc.collect()
    torch.cuda.empty_cache()


def pp_rank(group, rank, device, tmp):
    """One rank of phase 27: its stage's layers through ``pipeline_forward``
    on the flat group, the backward of Σ out² (zeros on stages 0-2, which
    take part all the same), each held here to the reference's file."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.pp import pipeline_forward

    device = torch.device(device)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    cfg = get_arch(PP_ARCH)
    per = PP_LAYERS // PP_STAGES
    mine = [pp_layer(torch, cfg, rank * per + j, device) for j in range(per)]
    stage = {k: torch.stack([lp[k] for lp in mine]).requires_grad_(True) for k in mine[0]}
    del mine
    x = pp_inputs(torch, cfg, device).requires_grad_(True)
    layer_fn = pp_layer_fn(torch, cfg, device)
    coll.reset_tp_counts()
    out = {}
    for rep in range(2):  # the first call warms the allocator and the kernels
        for v in [x, *stage.values()]:
            v.grad = None
        torch.cuda.synchronize()
        coll.barrier(group)
        t0 = time.perf_counter()
        y = pipeline_forward(layer_fn, stage, x, group=group, n_stages=PP_STAGES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        out.setdefault("fwd_ms", []).append((t1 - t0) * 1e3)
        out.setdefault("bwd_ms", []).append((time.perf_counter() - t1) * 1e3)
    out["ring_calls"] = coll.tp_counts().get("ppermute_ring", 0)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    path = os.path.join(tmp, f"pp_stage{rank}.pt")
    ref = torch.load(path)
    os.remove(path)
    gaps = {}
    for k, v in stage.items():
        want = ref["grads"][k].to(device)
        gaps[k] = ((v.grad - want).abs().max().item(), want.abs().max().item(),
                   bool(torch.equal(v.grad, want)))
    out["grad_gaps"] = gaps
    if rank == 0:
        want = ref["g_x"].to(device)
        out["gx_gap"] = ((x.grad - want).abs().max().item(), want.abs().max().item(),
                         bool(torch.equal(x.grad, want)))
    else:
        out["gx_zero"] = int(torch.count_nonzero(x.grad))
    if rank == PP_STAGES - 1:
        want = ref["out"].to(device)
        out["out_gap"] = (y - want).abs().max().item()
        out["out_within"] = bool(torch.isclose(y, want, rtol=PP_RTOL, atol=PP_ATOL).all())
        out["out_equal"] = bool(torch.equal(y, want))
    else:
        out["out_nonzero"] = int(torch.count_nonzero(y))
    return out


def pp_checks(torch, checks, ranks) -> collections.Counter:
    """Phase 27's checks on each rank's :func:`pp_rank` result; the phase
    launches no kernel of ours."""
    from repro_torch.configs.base import get_arch
    from repro_torch.parallel.pp import bubble_fraction

    d = get_arch(PP_ARCH).d_model
    ticks = PP_MICRO + PP_STAGES - 1
    last = ranks[-1]
    checks.true(f"pipeline: the last stage's output within rtol {PP_RTOL}, atol {PP_ATOL} of "
                f"the sequential stack (max_abs_err {last['out_gap']}, bit-equal "
                f"{last['out_equal']})", last["out_within"])
    for s, r in enumerate(ranks[:-1]):
        checks.true(f"pipeline: stage {s}'s output zeros", r["out_nonzero"] == 0)
    for s, r in enumerate(ranks):
        for k, (err, scale, equal) in r["grad_gaps"].items():
            checks.true(f"pipeline: stage {s} gradient {k}: max_abs_err {err:.3g} of "
                        f"max |grad| {scale:.3g} (tol {PP_GRAD_TOL} of it; bit-equal {equal})",
                        err <= PP_GRAD_TOL * scale)
        checks.true(f"pipeline: stage {s}: {r['ring_calls']} ring sends over 2 runs "
                    f"(one a tick each way: {4 * ticks})", r["ring_calls"] == 4 * ticks)
    err, scale, equal = ranks[0]["gx_gap"]
    checks.true(f"pipeline: stage 0's input gradient: max_abs_err {err:.3g} of max |grad| "
                f"{scale:.3g} (tol {PP_GRAD_TOL} of it; bit-equal {equal})",
                err <= PP_GRAD_TOL * scale)
    for s, r in enumerate(ranks[1:], 1):
        checks.true(f"pipeline: stage {s}'s input gradient zeros", r["gx_zero"] == 0)
    fwd = [[round(t, 1) for t in r["fwd_ms"]] for r in ranks]
    bwd = [[round(t, 1) for t in r["bwd_ms"]] for r in ranks]
    print(f"pipeline: {PP_LAYERS} layers of {PP_ARCH} (d {d}), {PP_LAYERS // PP_STAGES} a stage "
          f"on {PP_STAGES} gloo ranks sharing one card (not a transport speed), {PP_MICRO} "
          f"microbatches of (1, {PP_SEQ}); forward ms {fwd}, backward ms {bwd} (cold, warm) a "
          f"rank; bubble fraction {bubble_fraction(PP_MICRO, PP_STAGES):.3f}; ring bytes a tick "
          f"{PP_SEQ * d * 4:,}; peak GiB a rank {[round(r['peak_gib'], 2) for r in ranks]}",
          flush=True)
    return collections.Counter()


# phases 11 and 23-27 in one spawn, in this order: (key, label printed)
GRID_PHASES = (("11", "ranks phase"), ("23", "tensor parallelism phase"),
               ("24", "tp checkpoint and serve phase"), ("25", "tp recurrent serve phase"),
               ("26", "tp baselines phase"), ("27", "pipeline phase"))
# the spawn's limit: the sum of the four spawns it replaced (900 + 900 + 900 +
# 600 s), phase 26's 600 and phase 27's 300
GRID_TIMEOUT_S = 4200


def grid_rank(group, rank, device, tmp, fed24, fed25, frames25):
    """One rank of phases 11 and 23-27: phase 11's corners on the flat
    group of four, then the grid phases on the 2 x 2 grid, then phase 27
    on the flat group, in turn, its
    memory freed between them; each body's result and seconds, and the
    wall-clock time of this function's first line."""
    t_first = time.time()
    # cuBLAS's deterministic workspace (phase 24's checkpoint runs' deterministic
    # algorithms), read when the process makes its first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    bodies = {"11": lambda: rank_corners(group, rank, RANK_CORNERS, device),
              "23": lambda: tp_rank_paths(group, rank, TP_PATHS, device, tmp),
              "24": lambda: tp_ckpt_serve_rank(group, rank, device, tmp, fed24,
                                               out["23"]["paths"]),
              "25": lambda: tp_recurrent_serve_rank(group, rank, device, fed25, frames25),
              "26": lambda: tp_baselines_rank(group, rank, device),
              "27": lambda: pp_rank(group, rank, device, tmp)}
    out = dict(t_first=t_first, seconds={})
    for key, _ in GRID_PHASES:
        t0 = time.perf_counter()
        out[key] = bodies[key]()
        out["seconds"][key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def grid_phases(torch, ops, checks, device, card) -> dict:
    """Phases 11 and 23-27: every reference in this process first (phase
    11's local backend, the grid phases' tp = 1 runs, phase 27's sequential
    stack), then one spawn of four gloo ranks running the six phase bodies
    in turn (:func:`grid_rank`), then each phase's checks, in a temporary
    directory under ``build/`` removed after. Returns each phase's launch
    counts by key."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_grid_", dir=ROOT / "build")
    try:
        return _grid_phases(torch, ops, checks, device, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _grid_phases(torch, ops, checks, device, tmp, card) -> dict:
    from repro_torch.parallel.spawn import run_ranks

    n_dp, tp = TP_GRID
    refs_s = {}
    t0 = time.perf_counter()
    local11, launches11 = ranks_references(torch, ops, checks, device)
    refs_s["11"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step0, launches23 = tp_references(torch, ops, device)
    refs_s["23"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve24, tp1_24 = tp_ckpt_serve_references(torch, device)
    refs_s["24"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve25, frames25, tp1_25 = tp_recurrent_references(torch, device)
    refs_s["25"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_baselines_refusal(torch, checks)
    refs_s["26"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pp_references(torch, device, tmp)
    refs_s["27"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    print(f"grid phases: before the spawn this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the card has "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free", flush=True)
    t_spawn = time.time()
    ranks = run_ranks(grid_rank, n_dp * tp, args=(
        str(device), tmp, {k: v["fed"] for k, v in tp1_24.items()},
        {k: v["fed"] for k, v in tp1_25.items()}, frames25), backend="gloo",
        timeout_s=GRID_TIMEOUT_S)
    spawn_s = time.time() - t_spawn
    start = [r["t_first"] - t_spawn for r in ranks]
    inside = {key: max(r["seconds"][key] for r in ranks) for key, _ in GRID_PHASES}
    print(f"grid phases: one spawn of {n_dp * tp} gloo ranks on one card, {spawn_s:.1f}s; "
          f"start-up (spawn to each rank's first line) {[round(x, 1) for x in start]} s; "
          f"inside the ranks (the max over ranks) "
          f"{ {k: round(v, 1) for k, v in inside.items()} } s", flush=True)
    phase_checks = {
        "11": lambda res: ranks_checks(torch, ops, checks, res, local11, free, card),
        "23": lambda res: tp_checks(torch, ops, checks, res, step0, free),
        "24": lambda res: tp_ckpt_serve_checks(torch, ops, checks, res, serve24, tp1_24),
        "25": lambda res: tp_recurrent_checks(torch, checks, res, serve25, tp1_25),
        "26": lambda res: tp_baselines_checks(torch, ops, checks, res),
        "27": lambda res: pp_checks(torch, checks, res),
    }
    ref_launches = {"11": launches11, "23": launches23}
    launches = {}
    for key, label in GRID_PHASES:
        t0 = time.perf_counter()
        in_ranks = phase_checks[key]([r[key] for r in ranks])
        checks_s = time.perf_counter() - t0
        launches[key] = ref_launches.get(key, collections.Counter()) + in_ranks
        print(f"{label}: {refs_s[key] + inside[key] + checks_s:.1f}s ({refs_s[key]:.1f}s "
              f"of references here, {inside[key]:.1f}s inside the ranks, {checks_s:.1f}s of "
              f"checks); the four ranks' launches {dict(+in_ranks)}", flush=True)
    print(f"grid phases: {time.time() - t_spawn + sum(refs_s.values()):.1f}s in all (the "
          f"spawn's start-up {max(start):.1f}s)", flush=True)
    return launches


def dryrun_phase(checks) -> None:
    """``python -m repro_torch.launch.dryrun --all`` in this process (its
    ``main``, the output captured; meta tensors: no memory, no kernel, no
    card): a line for every runnable cell, none with an error, printed as
    a table."""
    import io

    from repro_torch.configs.base import runnable_cells
    from repro_torch.launch import dryrun

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--all"])
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    want = [(a, s) for a, s, runnable in runnable_cells() if runnable]
    checks.true(f"dry run: a line for each of the {len(want)} runnable cells ({len(lines)} "
                f"lines)", [(x["arch"], x["shape"]) for x in lines] == want)
    for x in lines:
        if "error" in x:
            checks.true(f"dry run {x['arch']} {x['shape']}: {x['error']}", False)
            continue
        groups = ", ".join(f"{k} {v:.3f}" for k, v in x["gib_per_rank"].items())
        print(f"  dry run {x['arch']} {x['shape']} ({x['grid']['ranks']} ranks): {groups} GiB a "
              f"rank; arguments {x['args_gib_per_rank']:.3f} of {x['card_gib']:.2f} GiB "
              f"({x['card']}; activations not counted) fit {x['args_fit_card']}; model FLOPs "
              f"a chip {x['model_flops_per_chip']:.4g}", flush=True)


def main() -> None:
    # segments that grow in place keep the cache from fragmenting, here and
    # in phase 11's ranks (which inherit it), as four processes share 80 GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops

    device = torch.device("cuda", 0)
    checks = Checks()
    t_start = time.perf_counter()
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    build.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f}s -> {build.library_path()}", flush=True)
    build.library()

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    timings = kernels_phase(torch, ops, checks, device)
    print(f"kernels phase: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    block_norms_phase(torch, ops, checks, timings, device)
    print(f"block_norms phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 3-8. the paths through the user entry point, counts read per path
    launches = {k.name: 0 for k in ops.KERNELS}
    bf16_launches = collections.Counter()  # only these paths have bf16 params
    histories, peaks = {}, {}
    for label, layers, steps, opt, comp, wire, lr, route in PATHS:
        t0 = time.perf_counter()
        counts, histories[label], peaks[label] = train_phase(
            torch, ops, checks, device, label=label, layers=layers, steps=steps, opt=opt,
            comp=comp, wire=wire, lr=lr, **route)
        for name, c in counts.items():
            launches[name] += c
        bf16_launches.update(ops.bf16_launch_counts())  # this path's, read just after it
        print(f"{label}: {time.perf_counter() - t0:.1f}s", flush=True)
    for label, h in histories.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {peaks[label]:.1f} GiB", flush=True)
    for b16, f32 in BF16_OF.items():
        print(f"bf16 params: {b16} {compressed_ms(histories[b16]):.1f} ms a step (median of "
              f"steps 2+), peak {peaks[b16]:.1f} GiB; float32 {f32} "
              f"{compressed_ms(histories[f32]):.1f} ms, {peaks[f32]:.1f} GiB", flush=True)

    # 9. the ZeRO-1 route against the fused one, and the baselines' gaps
    cross_route_phase(checks, histories)

    # 10. step 1 replayed for one leaf: unpack(sum of words) == sum of images
    print(f"recorder first use: {recorder_first_use(torch):.1f}s (imports, once a process; "
          f"{card})", flush=True)
    t0 = time.perf_counter()
    wire_phase(torch, checks, device, card)
    print(f"wire phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # the static audits: (a) ran in the wire phase, (b) the ZeRO-1 ring
    # route here, (c) in the grid phases' spawn, (d) after the dry run
    t0 = time.perf_counter()
    zero1_ring_audit(torch, checks, device, card)
    print(f"zero1 ring audit phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 11. four real ranks (gloo) sharing the card, against the local
    # backend: in the grid phases' spawn, first in its ranks (below)

    # 12. a one-rank NCCL group: int32 and int8 payloads, and a ZeRO-1 path
    t0 = time.perf_counter()
    for name, c in nccl_phase(torch, ops, checks, device).items():
        launches[name] += c
    print(f"nccl phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 13. the n-worker simulator: the convergence milestone and logreg
    t0 = time.perf_counter()
    for name, c in simulator_phase(torch, ops, checks, device).items():
        launches[name] += c
    print(f"simulator phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 14. the baselines at the largest 2-layer leaf, card against the CPU
    t0 = time.perf_counter()
    baseline_phase(torch, checks, device)
    print(f"baselines phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 15. the rest of the dense family at published width
    t0 = time.perf_counter()
    counts, b16, dense_hist, dense_peaks = dense_family_phase(torch, ops, checks, timings,
                                                             device)
    for name, c in counts.items():
        launches[name] += c
    bf16_launches.update(b16)
    for label, h in dense_hist.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {dense_peaks[label]:.1f} GiB", flush=True)
    print(f"dense family phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 16. checkpoint and resume on the card
    t0 = time.perf_counter()
    for name, c in checkpoint_phase(torch, ops, checks, device).items():
        launches[name] += c
    print(f"checkpoint phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 17. the moe family at published width
    t0 = time.perf_counter()
    counts, b16, moe_hist, moe_peaks = moe_family_phase(torch, ops, checks, device)
    for name, c in counts.items():
        launches[name] += c
    bf16_launches.update(b16)
    for label, h in moe_hist.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {moe_peaks[label]:.1f} GiB", flush=True)
    print(f"moe family phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 18. the hybrid family at published width
    t0 = time.perf_counter()
    counts, b16, hyb_hist, hyb_peaks = hybrid_family_phase(torch, ops, checks, timings, device)
    for name, c in counts.items():
        launches[name] += c
    bf16_launches.update(b16)
    for label, h in hyb_hist.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {hyb_peaks[label]:.1f} GiB", flush=True)
    print(f"hybrid family phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 19. the xLSTM family at published width
    t0 = time.perf_counter()
    counts, b16, xl_hist, xl_peaks = xlstm_family_phase(torch, ops, checks, device)
    for name, c in counts.items():
        launches[name] += c
    bf16_launches.update(b16)
    for label, h in xl_hist.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {xl_peaks[label]:.1f} GiB", flush=True)
    print(f"xlstm family phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 20. the encdec family at published width and full depth
    t0 = time.perf_counter()
    counts, b16, ed_hist, ed_peaks = encdec_family_phase(torch, ops, checks, device)
    for name, c in counts.items():
        launches[name] += c
    bf16_launches.update(b16)
    for label, h in ed_hist.items():
        print(f"path {label}: compressed step ms {[round(r['ms'], 1) for r in h[1:]]}, "
              f"peak {ed_peaks[label]:.1f} GiB", flush=True)
    print(f"encdec family phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 21. the serve path and the runtime
    t0 = time.perf_counter()
    for name, c in serve_runtime_phase(torch, ops, checks, device).items():
        launches[name] += c
    print(f"serve and runtime phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 22. the recurrent and encoder-decoder decode
    t0 = time.perf_counter()
    for name, c in recurrent_decode_phase(torch, ops, checks, device).items():
        launches[name] += c
    print(f"recurrent and encdec decode phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # the dry run: every runnable cell's per-rank argument bytes
    t0 = time.perf_counter()
    dryrun_phase(checks)
    print(f"dry run phase: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    static_audit_phase(checks, card)
    print(f"static audit phase: {time.perf_counter() - t0:.1f}s", flush=True)

    # 11 and 23-27, one spawn of four gloo ranks sharing the card: 11 the
    # ranks on a flat group against the local backend, then on a 2 x 2 grid
    # 23 tensor parallelism, 24 checkpoints, the elastic resume and TP
    # serving, 25 the hybrid, ssm and encoder-decoder decode, 26 the paper's
    # other compressors, then on the flat group 27 pipeline parallelism
    for counts in grid_phases(torch, ops, checks, device, card).values():
        for name, c in counts.items():
            launches[name] += c
    print(f"audits: {sum(AUDIT_SECONDS.values()):.1f}s in all (recording and auditing; "
          f"{ {k: round(v, 2) for k, v in AUDIT_SECONDS.items()} }) on {card}", flush=True)

    print(f"all phases: {time.perf_counter() - t_start:.1f}s", flush=True)

    # the kernel line, the card line, the result
    kernels = []
    for op in ops.KERNELS:
        row = timings.main_row(op.name)
        kernels.append({
            "name": op.name, "route": "cuda",
            "source": f"src/repro_torch/{op.source}",
            "replaces": REPLACES[op.name], "launches": launches[op.name],
            "max_abs_err": timings.err[op.name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "bf16_launches": bf16_launches[op.name],
            # every variant timed at the largest leaf (the main one first)
            "variants": [{k: r[k] for k in ("variant", "ms", "plain_ms", "bound_ms", "bound_by",
                                            "bytes", "library_ms")}
                         for r in sorted(timings.rows, key=lambda r: r is not row)
                         if r["name"] == op.name],
        })
    for k in kernels:
        lib = "" if k["library_ms"] is None else f", library {k['library_ms']:.3f} ms"
        # time lost to the bound over the driven paths, were every launch at
        # the largest leaf (an overestimate for kernels run mostly on small
        # leaves): the order in which to redesign the kernels
        excess = k["launches"] * (k["ms"] - k["bound_ms"])
        print(f"kernel {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f} ms{lib}, "
              f"bound {k['bound_ms']:.3f} ms by {k['bound_by']}), "
              f"{k['launches']} launches over the driven paths, "
              f"launches x (ms - bound) = {excess:.1f} ms", flush=True)
    if checks.failed:
        fail("; ".join(checks.failed))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
