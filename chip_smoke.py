#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ddp_practice_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught and passed):

1. setup: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from csrc/ with nvcc (all four sources at once), the
   native loader's gather (csrc/dataloader.cpp) with g++, and print
   ptxas's register and spill lines; then the bf16 flash kernels' (E, G,
   F), kernels J's and K's and the Hopper kernel H's ptxas lines by name,
   and per head_dim the E, G and F blocks' shared memory, threads and
   blocks an SM (the runtime's occupancy calculator), J's and K's per tile
   width, and H's at the ViT-Tiny and causal LM layers (sequences a tile,
   ring stages);
2. kernels: hold each kernel against its plain PyTorch version at lm_base
   shapes (h=12, hd=64) and print its device time (CUDA events around one
   call queued behind a spin kernel, L2 flushed before each, median of
   20), the plain version's time, a yardstick PyTorch call's time (the
   port never calls it) and the HBM-bytes bound over the card's memory
   rate (utils/flops.chip_hbm_bandwidth; an unknown card stops the smoke);
   first the harness's floor, torch.cuda._sleep(1) timed the same way:
   - kernels A and B (flat cache): b in {1, 8}, L in {1024, 2048}, cur in
     {0, mid, L-1}, random attn_start; b = 1 bf16 over every position of
     L = 32768 (A and B) and 65536 (A); plus the serve path's shape; the
     yardstick is F.scaled_dot_product_attention on the same masked
     problem;
   - kernels C and D (paged pool): 16-position blocks, 128 blocks per
     slot (2048 positions) over a 1 + 8*128-block pool, b in {1, 8},
     lengths 0, mid and 2047 mixed across slots, random attn_start, two
     slots sharing blocks and one retired garbage-block row; b = 1 bf16
     over every position of 2048 blocks (C and D) and 4096 (C); plus the
     main path's shapes (the paged serve row's mid-run step for C, the
     int8 shared-prefix run's step for D). No single PyTorch call walks a
     page table, so the yardstick is SDPA over each slot's span gathered
     OUTSIDE the timed region: it skips the gather the kernel does;
3. serve: lm_base under the bf16 policy from a seeded random init
   (d=768, depth 12, 12 heads, mlp 3072, vocab 256) serves a Poisson trace
   through serve_bench's continuous, static and paged rows; every request
   completes, and in each row each kernel's launches equal depth x that
   row's decode steps (A in the slot and static rows, C in the paged row,
   nothing else). A shorter int8-cache run does the same for kernel B;
4. shared prefix: shared_prefix_bench at lm_base bf16 with its undersized
   pool, plain paged vs prefix cache (hit rate, preemptions, goodput
   ratio), then again over an int8 pool for kernel D;
5. spec: spec_decode_bench at lm_base fp32: token identity between the
   plain paged and the speculative arm must be 1.0; kernel C's launches
   include the verify correction steps;
6. cross-check (fp32, one deterministic schedule): the slot engine and
   the paged engine, each with its kernel and with the plain version,
   emit identical greedy tokens;
7. profile: where one decode step of the serve configuration spends its
   time, for the slot and the paged engine (torch.profiler over two
   bursts with every slot busy): host wall per step, device busy time per
   step and the device's idle share, device ops per step, and the
   attention kernel's share;
8. flash kernels: E (forward) and F+G (backward) against their plain
   versions at the lm_base training shape (b=8, h=12, d=64, s=2048,
   causal, bf16) with packed and fused-QKV strides, at s=8192 b=1, folded
   at h=24 d=32 (the folded leg's shape) and in fp32 at s=512, with
   kernel, plain and SDPA (F.scaled_dot_product_attention, forward and
   its autograd backward; the port never calls it) device times and the
   bound, forward and backward apart; the backward also as its two
   launches timed alone, G (dq and the delta scratch) and F (dk, dv);
8b. flash variants (row #12, the reference's ablations of E, each E's
   body with one lever changed): each variant kernel's ptxas line and
   footprint (shared memory, threads, blocks an SM); v2 (causal
   and not), v3, v4, v5 at 2 and 4 heads per block and nomax against their
   plain versions at lm_base (b*h = 96, s = 2048, d = 64, bf16) on the
   kernel's own 64-key tiles (out at the flash bf16 limits, lse 1e-4, or
   2^-8 where l sums the rounded p; for v3 and v5 the mean lse error
   against their own plain version stays under a tenth of its mean
   distance from plain v2, which sums fp32 p), and fwd4d (kernel E's
   packed route on the (b, s, h, d) strides) against E's plain version,
   with the fold-and-transpose path logged beside; kernel, plain (the
   reference's 512 x 1024 blocks) and library flash
   (SDPBackend.FLASH_ATTENTION; the port never calls it) device times and
   the bound, and each variant's time over kernel E's on the same
   operands (folded, causal or not). Then the slice's main path: the
   `main()` of
   experiments/flash_variants, flash_ablate, flash_4d, flash_profile and
   flash_time, each with the launch counts zeroed just before and read
   just after; the variants' launches in flash_variants and flash_ablate,
   E's packed launches in flash_4d, are the rows' counts;
9. train: `fit` through the CLI's parser and config, lm_base (d=768,
   depth 12, 12 heads, mlp 3072) at seq 2048, batch 8, bf16, AdamW lr
   3e-4, attn_impl flash, 30 steps on the synthetic Markov corpus, host
   data (`--data_placement host`: eager steps): the loss at steps 1, 10,
   20, 30 (30 below 1), the median step time (CUDA events between step
   ends), tokens/s, MFU against 989.4e12, eval accuracy and perplexity,
   peak memory; flash_fwd_packed launches equal 12 x (30 + eval batches)
   and flash_bwd_packed 12 x 30; then the resident leg (the corpus on the
   device, `--steps_per_call 10`, 20 steps: each call replays of one
   captured step): its losses at steps 10 and 20 equal the host leg's
   (1e-3 relative; said whether bit-identical), launches counted through
   the replays (graph replays launch what the captured step did:
   utils/graphs.REPLAYED), the two median steps side by side;
10. legs, resident ("auto", one replay a step): 10 steps with RoPE (the
   packed rows again, through dot_product_attention) and 10 with 24 heads
   of 32 (the folded rows), then 25 steps of the learned run with
   `--profile_dir`: fit writes one
   Kineto trace of steps 10-19, read back with utils/xprof.op_summary (E,
   F and G 12 x 10 times each); that leg's median step leaves those steps
   out and logs theirs beside;
11. cross-check, one lm_base train step at depth 2, b=2: in fp32 at
   s=512 the kernels, the plain versions and attn_impl="xla" give one
   loss (1e-5) and grads (1e-4); in bf16 at s=2048 the tensor-core
   kernels and the plain versions give one loss (1e-3 relative) and
   grads within 1e-2 of each grad's norm;
12. train profile: one bf16 lm_base train step under torch.profiler:
   host wall, device busy, idle share, device ops, E/F/G's share;
13. fused encoder kernels: H (forward) and I (backward) against their
   plain versions at the ViT-Tiny layer (1024 sequences of 64, d=192, 3
   heads, mlp 768) in bf16 and fp32, the causal LM layer (d=256, 4 heads,
   mlp 1024, s=128) in both, and an odd batch of 7: out, dx and each of the
   12 parameter grads held apart, with kernel and plain device times, the
   bound, and in the library column the port's own unfused EncoderBlock
   (cuBLAS + eager ops; no single PyTorch call computes the layer): its
   forward for H, its forward + backward for I; in bf16 where the Hopper
   kernel H runs, the general kernel H it replaced, held to the same limits
   and timed beside it; I also in its parts: the per-sequence launch (with
   its vector-grad reduction) and the four kernel K launches of its weight
   grads (each with K's second pass);
14. ViT train: `fit` through the CLI's parser and config, vit_tiny (d=192,
   depth 12, 3 heads, mlp 768) on the synthetic CIFAR-10 fallback, bf16,
   batch 1024 (the reference bench's shape), Adam lr 1e-4 (the bench's SGD
   at lr 1e-4 moves the loss less than its batch noise in 30 steps, and
   this phase asserts a falling loss), 30 steps plus the eval pass, with
   `--fused auto` (no flag), on host data and then resident (each step a
   graph replay; its losses equal the host leg's at 1e-3 relative, and
   the two median steps side by side): loss at steps 1, 10, 20, 30 (30
   below 1),
   median step, images/s, MFU against 989.4e12, eval accuracy, peak
   memory; fused_encoder_fwd launches equal 12 x (30 + eval batches),
   fused_encoder_bwd 12 x 30, and kernel K (tgmm, and its second pass
   tgmm_reduce) 4 x 12 x 30: I's four weight grads. Then one profiled
   step of the host leg (H, I, I's K launches, I's reduction, other: H's
   share of the step's device time), and a host leg of 10 steps with
   `--fused off` and its profiled step (a reading, not a claim);
15. ViT cross-check: one vit_tiny train step at depth 2, batch 64: in fp32
   the kernels, the fused layer's plain version and `fused=False` give one
   loss (1e-5) and grads (2e-4, scaled by each grad's largest magnitude
   above 1); in bf16 the kernels and the plain version give one loss (1e-3
   relative) and grads within 1e-2 of each grad's norm;
16. grouped matmul kernels: J (gmm, and its transposed-rhs form for the
   input grad) and K (tgmm, the per-group weight grad) against their plain
   versions at the lm_moe shapes (m = 32768 sorted rows, E = 8, (k, n) =
   (768, 3072) and (3072, 768)) with balanced, skewed and empty-expert
   off-grid group sizes in bf16, plus fp32, and K with fp32 output; on the
   balanced and skewed shapes the kernel, plain and library device times
   (torch._grouped_mm where this torch takes the operands, else a torch.mm
   loop over the groups: the line says which; the port calls neither) and
   the bound 2*m*k*n over the dtype's peak;
17. MoE train: lm_moe at the reference's lm_moe_tc configuration
   (bench.py:133-141: lm_base widths, 6 of 12 blocks routed over 8 experts,
   top-2, strided routing groups of 256, capacity factor 1.5), seq 2048,
   batch 8, bf16, AdamW lr 3e-4, flash attention, on the synthetic Markov
   corpus, built through create_model("lm_moe", ...) and trained with the
   optimizer, steps and batches `fit` uses (the CLI cannot set lm_base
   widths for lm_moe): 20 steps plus 3 eval batches on the einsum path,
   then again with every MoEMlp.impl = "sorted" (kernels J and K): loss at
   steps 1, 10, 20 (20 below 1), median step, tokens/s, MFU over active
   FLOPs, moe_drop_rate/load_max/load_min, peak memory; the flash rows
   launch 12 x (steps + eval batches) and 12 x steps; on the sorted leg the
   drop rate is exactly 0, J forward launches 2 x 6 x (steps + eval
   batches), J transposed, K and K's second pass 2 x 6 x steps; a profiled
   step per leg;
18. the CLI's own fit leg: --model lm_moe --moe_router expert_choice at the
   registry's dims, 10 steps, its summary's moe_* keys;
19. MoE cross-check, one lm_moe step at depth 2, b=2, capacity factor E/k
   (the einsum path drops nothing): in fp32 at s=512 the einsum path and
   the sorted path on the kernels and on their plain versions give one
   loss (2e-5) and grads (5e-4, the reference's tests/test_moe.py); in bf16
   at s=2048 kernels vs plain: loss 1e-3 relative, each grad within 1e-2 of
   its norm;
20. (run right after setup, before any phase that traces: a finished
   torch.profiler trace adds host time to every later launch in the
   process, experiments/convnet_step.py) ConvNet/MNIST train, the
   reference's BASELINE metric: `fit` through
   the CLI with its defaults (config 1: convnet, MNIST, 3 epochs, batch 32,
   SGD lr 1e-4, fp32; no MNIST files here, so the synthetic stand-in at
   60000/10000 images; "auto" placement: the corpus on the device, each
   step one replay of the captured step), evaluating after every epoch:
   images/s per card and the median step (CUDA events between step
   ends), MFU against the dense bf16 peak, the test accuracy after each
   epoch and the epochs to 91% (reported, not gated); the loss must fall
   and the last accuracy reach 0.5 (chance 0.1). The host leg (eager
   steps, `--data_placement host`) for one epoch, whose first 50 losses
   must equal the resident leg's at 1e-6 relative (said whether
   bit-identical). A bf16 leg of one epoch (config 2's precision on one
   card; accuracy 0.3 or more), a leg on tests/data/mini_mnist
   (real-format IDX files, Adam), then phase 21, then profiles: 20
   resident steps as the epoch runs them, one eager step of the host leg
   and of the bf16 run (host wall, device busy, idle share, device time
   by kind: cuDNN convs, matmul, pooling, reductions, elementwise,
   other), then phase 23;
21. ConvNet resume on the card: save after each of 2 epochs, truncate the
   newest manifest, resume a 3-epoch run (it falls back to the epoch-1
   checkpoint and takes up epoch 2) and hold its final state against an
   uninterrupted 3-epoch run (cuDNN deterministic for this leg; 1e-5
   relative, and whether bit-identical);
22. generate and serve from a checkpoint: lm_base (RoPE, bf16) trains 6
   steps on the repo's CUDA sources with periodic (asynchronous) and
   final checkpoints; the lm_base train state's save, save_async and
   restore wall times; generate.py greedy from the checkpoint with the
   policy cache (kernel A launches depth x decode steps, nothing else)
   and `--kv_cache int8` (kernel B likewise); at fp32 the kernel and plain
   decode give identical greedy tokens for both caches; serve/bench.py
   `--ckpt_dir` serves 4 prompts through the slot engine and every
   request completes;
23. ResNets (ROADMAP A2; no kernel of the port lies on their path: cuDNN
   convs, ATen BatchNorm ops, the augmentation's gathers and batched
   contractions), `fit` through the CLI at the reference bench's shapes
   (bench.py:78-85), bf16, SGD momentum 0.9 (lr 0.05; ResNet-50 0.01,
   where its loss falls in 20 steps): ResNet-18 on the
   synthetic CIFAR-10 set (config 3: 50000/10000 images, batch 512,
   `--augment` crop_flip), 30 steps and the eval pass with "auto"
   placement (the corpus resident, each step a graph replay), then a host
   leg of eager steps over the same 30 steps whose per-step losses equal
   the resident leg's at 1e-3 relative; ResNet-50 (config 5: 224x224x3,
   1000 classes, batch 128, `--augment_kind rrc`, `--loader native`) on
   the synthetic ImageNet corpus cut to 4096/1024 images, written under
   build/ (write time; the native against the numpy gather of a batch,
   bit-equal), 20 steps on the host path and the eval pass, the corpus
   deleted after its profile. Each leg: loss at steps 1/10/20/30 (the
   last below the first), median step, images/s per card, MFU, eval
   accuracy, peak memory; each profile: host wall, device busy, idle
   share, device ops a step, device time by kind;
Phases 24-26 run first of all, right after setup: their decode steps are
host-bound, and a finished torch.profiler trace adds host time to every
later launch in the process.
24. MoE serving (ROADMAP A10): lm_moe at lm_base width (12 blocks of d
   768, 12 heads of 64, mlp 3072, every second block routed over 8
   experts, top-2, router biases N(0, 0.5)), RoPE, bf16, token choice on
   the einsum path, through serve_bench's continuous, static and paged
   rows: every request completes and each row launches its kernel (A, A,
   C) depth x its decode steps;
25. MoE sorted decode: kernel J against gmm_plain at the decode and
   prefill shapes of the sorted path (m = 8, 16, 128 and 512 rows over 8
   experts, empty groups included, both expert products, bf16 and fp32;
   the 8-slot step timed), then lm_moe at lm_base width in fp32 with
   impl="sorted" serves six requests through the slot engine: its greedy
   tokens equal generate's, each request alone, and J launches 2 x 6 x
   the model's applications, A 12 x its single-token steps; expert choice
   at decode (fp32): generate over four left-padded prompts, each prompt
   alone and the slot engine give the same greedy tokens;
26. MoE checkpoint: the registry's lm_moe (d 256, 8 heads of 32: the
   plain masked decode, no kernel) trains 6 steps through the CLI with a
   checkpoint; load_lm restores its router biases (non-zero, equal to the
   trained ones), generate.py and serve/bench.py `--ckpt_dir` complete;
27. (none: the bench's entries are timed by benchmarks.py alone, `python
   -m ddp_practice_tpu_torch.benchmarks --models
   convnet,lm_decode,lm_decode_moe`; the CPU tests hold every report key
   against the reference's.)
28. parallel (ROADMAP A8a; run right after setup): lm_base at full width
   (d 768, 12 heads, mlp 3072, depth 12, s 2048, fp32, flash, SGD with
   momentum and clipping, one seed's weights) through the CLI's Trainer,
   the ranks as threads of this process on the one card
   (parallel/threads.py: several ranks cannot share a card over NCCL):
   three steps of global batch 4 on one rank, then under tensor 2, FSDP
   over data 2 and tensor 2 x FSDP data 2, each held to the one-rank run
   (loss rtol 2e-4, every parameter rtol 1e-3 / atol 1e-5, the
   reference's TP tolerances) with E/F/G's launches per rank per step
   (12 forward and 12 backward on the packed route: 6 heads a rank at
   tensor 2); then greedy generation of 32 tokens at tensor 2 against
   the one-rank generate (tokens identical, kernel A 12 launches per
   token per rank). Step times there are of ranks sharing one card, not
   a speed. The phase prints its wall time.
29. sequence (ROADMAP A8b; right after phase 28): the same lm_base run
   (PAR_ARGS, global batch 4, 3 steps) under --seq 2 --sp_impl ring,
   --seq 4 --sp_impl ring, --seq 2 --sp_impl ulysses and --tensor 2
   --seq 2 --sp_impl ulysses, the ranks as threads on the one card, each
   held to phase 28's one-rank run (loss rtol 2e-4, every parameter rtol
   1e-3 / atol 1e-5). Each rank reads its own E and G+F launches a step
   (`_RankTally`): the causal ring 12 (r + 1) on rank r (the folded row:
   r earlier blocks full, its own causal, the later ones skipped),
   Ulysses 12 packed at 6 heads a rank (seq 2) and 12 on the folded row
   at 3 heads ("heads" route; tensor 2 x seq 2). Then the ring's kernel
   check: its flash local (E per block, the logsumexp merge, G+F with
   the merge's lse cotangent) against its plain blockwise local on 4
   ranks at (b, s, h, d) = (2, 2048, 12, 64), bf16 and fp32, causal and
   not: output, merged lse and dq, dk, dv of a loss reading out and lse,
   element by element within the flash rows' limits, in relative norm
   within FLASH_REL (fp32) and RING_REL (bf16: the plain local rounds
   nothing before its output). The legs' launches join the flash rows'
   in the kernels' record; the phase prints its wall time.

30. expert (ROADMAP A8c and A8f; right after phase 29): lm_moe_tc
   (lm_base widths, 12 layers, 6 routed over 8 experts, top-2, strided
   routing groups of 256, capacity 1.5, seq 2048, flash attention) in
   fp32 under phase 28's optimizer (SGD, momentum 0.9, clipping 1.0, lr
   1e-2), global batch 4, 3 steps through `parallelize` and
   `make_lm_train_step`, the ranks as threads on the one card, every
   rank and leg starting from one seed's weights: one rank on the einsum
   and on the sorted path first, then expert 2 and expert 4 einsum,
   expert 2 sorted, data 2 x expert 2 gather with FSDP, seq 2 ring
   einsum, seq 2 Ulysses sorted and expert 2 x seq 2 ring, each held to
   the one-rank run of its function (gather computes einsum's): losses
   within PAR_LOSS_RTOL and equal on every rank, the router metrics
   (moe_drop_rate, moe_load_max, moe_load_min) within 1e-6 on every rank
   and step, every parameter within PAR_RTOL / PAR_ATOL; each rank's E,
   G+F, J and K launches a step at their formulas (a per-thread tally:
   12 packed, the ring's 12 (r + 1) folded on seq rank r, the sorted
   path's 2 J, 2 J transposed, 2 K and 2 second passes a routed layer).
   Then 32 greedy tokens of lm_moe_tc at expert 2 against one rank's
   (identical, kernel A 12 a token a rank), and `--model lm_moe --expert
   2` through the CLI's parser and `fit` (5 steps, no compare). The
   legs' launches join the flash and grouped-matmul rows in the kernels'
   record; the phase prints its wall time.
31. pipeline (ROADMAP A8d; right after phase 30): lm_pipe at lm_base's
   widths (d 768, 12 heads, mlp 3072, depth 12, s 2048, the synthetic
   corpus's vocabulary), fp32, flash, remat as the registry has it, under
   phase 28's optimizer, global batch 4, 3 steps through `parallelize`
   and `make_lm_train_step`, every rank starting from one seed's
   weights, the ranks as threads on the one card: one rank at
   num_stages 1 (the yardstick), then pipe 2 GPipe M 2, pipe 4 GPipe
   M 4, pipe 4 1F1B M 4, pipe 2 interleaved (V 2) M 2, data 2 x pipe 2
   1F1B M 2, pipe 2 x tensor 2 1F1B M 2 and pipe 2 x seq 2 ring GPipe
   M 2, each held to the yardstick (losses within PAR_LOSS_RTOL and
   equal on every rank, every parameter, gathered over pipe, within
   PAR_RTOL / PAR_ATOL) with each rank's E and G+F launches a step at
   `_pipe_expected`'s formulas, printed by rank. Then `--model lm_pipe
   --pipe 2 --pipe_schedule 1f1b` through the CLI's parser and `fit` (5
   steps, no compare). The legs' launches join the flash rows in the
   kernels' record; the phase prints its wall time. (`bench_pipeline`,
   the schedule sweep, is benchmarks.py's `pipeline` entry: `python -m
   ddp_practice_tpu_torch.benchmarks --models pipeline`.)

32. A8e (ROADMAP A8e-1, A8e-2; right after phase 31): elastic, lm_base
   at full width (bf16, seq 512, b 4, SGD momentum), 2 epochs of 3 steps
   through `fit` with --max_restarts 1 and a checkpoint each epoch, the
   first attempt killed after epoch 0's save (tests/elastic_worker.py's
   sabotage): 2 attempts, resumed at step 3, final parameters equal to an
   uninterrupted run's bit for bit; watchdog, a resident run with
   --watchdog 120 and whole-epoch calls capped at the probe interval (4
   steps), graph replays, probes on CUDA-event rungs, no firing; then a
   rung held behind torch.cuda._sleep past a 0.5 s timeout, whose probe
   makes `on_timeout` (a callback) fire once; the sorted MoE path
   captured, lm_moe (bf16, 8 experts) resident at 4 steps a call, its
   losses bit-identical to the eager host steps' with J and K in
   graphs.REPLAYED; sharded chunked steps on ranks as threads (eager by
   utils/graphs.py's rule), lm_base at tensor 2 and lm_pipe at pipe 2 x
   data 2 with FSDP under 1F1B (both 4 blocks at lm_base's widths) and
   vit_tiny at data 2 (DDP; fused "auto" takes the per-op path under
   several ranks, as the reference's gate does): a call of 4 chunked
   steps equals 4
   single steps bit for bit, each rank's launches printed; --devices 1
   trains, --devices 2 on one card raises. The legs' launches join the
   flash, fused and grouped-matmul rows.
33. router (ROADMAP A6a; right after the bench phase, before any trace):
   serve_bench's router row, SERVE's engine (8 slots, max_len 2048,
   buckets 16/64/256, burst 8) at lm_base, prompts 4-160 and 8-64 new
   tokens so that a failover's prompt + tokens so far fits the largest
   bucket, a seeded 12-request Poisson trace at 16/s. Leg 1, fp32: two
   replicas under ROUTER_PLAN (replica 1 crashed at its tick 5 for 0.1 s,
   a NaN in replica 0's first slot at its tick 2, a failed admission on
   replica 0 from its tick 3): none lost, every request ends "length"
   with the continuous row's greedy tokens (one engine, no faults),
   failovers >= 1, retries >= 2, breaker trips >= 1, replica 1 healthy
   again at the end, every replica's shape counts unchanged from after
   warmup, and kernel A launched 12 x the decode steps of all replicas
   (each row's own). Leg 2, bf16: the serve phase's trace through
   serve_bench(replicas=1) and (replicas=2) fault-free, then replicas=2
   under ROUTER_PLAN with ROUTER_SLO armed and the timeline written to
   build/router_trace.json: per row tokens/s (goodput), TTFT, TPOT and
   latency p50/p99, retries, failovers, breaker trips, replica states,
   the SLO alert log, router x1 against the continuous row; none lost,
   launches as in leg 1, and the trace passes tools/check_traces.py's
   `validate`. Its A launches join the kernels' record; the phase prints
   its wall time.
34. front door and fleet (ROADMAP A6b, A6c-1; right after phase 33):
   lm_base fp32 with ROUTER's engine and trace ranges. Leg 1:
   frontdoor_bench(procs=2), 12 requests at 16/s: wire against
   in-process (token identity 1.0), chunked prefill through two paged
   front doors (18 requests, long prompts of 720, chunk 32 against 0;
   identity 1.0, the short requests' TTFT p99 ratio printed), a SIGKILL
   of worker 0 (`WorkerSpec(device="cuda")` processes on this card) 0.75 s
   into the replay (none lost, a restart, every socket ending in a typed
   ok terminal), mixed greedy and sampled traffic (no new engine shape);
   tools/check_stream.py's --sse audit clean on every capture. Leg 2:
   qos_bench(procs=2) at the reference's traffic (100 req/s, hostile share
   4, 2 s, 2 slots, buckets 16/64): none lost in FIFO, fair and the fair
   fleet's SIGKILL leg, fair and SIGKILL tokens identical to FIFO's;
   isolation ratio, Jain's index and the alert attribution printed
   beside the reference's acceptance. In both legs each in-process row
   launched only its kernel (A; C in the paged rows), 12 x its decode
   steps, the rows' sum is the leg's whole count, and each live worker
   launched A 12 x its own decode steps. Leg 3, bf16, ungated:
   fleet_bench(procs=2, reps=2) on phase 33's trace: the fleet's latency
   p50 and tokens/s against the in-process x2 router's. Every leg reaps
   its workers and fails if one outlived its supervisor; the phase prints
   each leg's wall and its own, with the card's name and power limit.
35. elastic fleet (ROADMAP A6c-2; right after phase 34): lm_base fp32,
   greedy, through worker processes on this card. Leg 1:
   cache_routing_bench(procs=2) with the reference's pool (25 blocks of
   16) and trace (48 requests at 100/s, 4 prefixes of 96 tokens, 6
   order-balanced reps) through two paged, prefix-caching 2-worker
   fleets, affinity against least-loaded (brown-out off in both): each
   arm's goodput, prefix hit rate from the workers' own radix counters,
   latency, lost; gates lost 0, token identity 1 and hit-rate ratio > 1;
   the goodput ratio recorded. Leg 2: fleet_autoscale_bench at AUTOSCALE's
   rate, the reference's chunks (2 base, 3 at the 4x step, 7 base) and
   policy: a fixed 3-worker fleet against an elastic one of 1 to 3
   workers with one warm standby: goodput per worker-second, scale
   events, reaction, warm promotion against the same run's cold spawn;
   gates lost 0, reaction within the window, oscillation within its
   bound, promote_join_s < cold_spawn_s; the goodput-per-worker ratio
   recorded. In both legs this process launches no decode kernel and
   every live worker launched only its own (C in leg 1's paged workers,
   A in leg 2's), 12 x its own decode steps; each worker's counts are
   printed. Every leg reaps its workers; the phase prints each leg's wall
   and its own, with the card's name and power limit.

Launch counts are zeroed just before each phase's run and read just
after it; a train leg's count is its wrappers' (eager calls) plus its
graph replays' (utils/graphs.REPLAYED). The kernels' record adds the MoE
serve rows' launches to A's and C's, the router phase's to A's, the
front door phase's fp32 legs' (in-process rows and live workers) and the
elastic phase's live workers' to A's and C's, the sorted decode leg's to J's, the sequence and pipeline legs' to
E/F/G's, and the expert legs' to E/F/G's and J/K's. The ConvNet's, lm_base's and vit_tiny's
leg lines end with the card's name and power limit. Before the card's
line the script prints its own wall time. The second-to-last line is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.

Tolerances: fp32 2e-5 (the reference's decode-attention tests). bf16
|err| <= 1.6e-2 + 2^-7 |ref|: each kernel and its plain version round at
the same points (q*scale, p, the output) and differ only in fp32
summation order, which can flip the final bf16 rounding of an output, or
of one p, by an ulp (2^-7 relative, 7.8e-3 absolute below 1). Flash
holds the output and each of dq, dk and dv apart: element by element at
the reference flash tests' 2e-5 (forward) and 1e-4 (grads) in fp32, and
at the bf16 limit above in bf16 (the same rounding points: p, ds and the
outputs can flip by an ulp); and in norm, ||kernel - plain|| / ||plain||
under 1e-5 in fp32 and 2e-3 in bf16 per tensor, since ulp flips are rare
and scattered while a kernel wrong on one tile moves all of its elements.
The fused layer: fp32 2e-5 forward and 2e-4 grads (3e-4 causal) per
element, times the tensor's largest magnitude where that exceeds 1 (a
weight grad sums over up to 65536 tokens), 1e-5 in relative norm. bf16:
kernel and plain round at the same ~10 points (y1, qkv, p, o, y2, hg, g,
dx2, do, ds, dqkv) and differ in fp32 summation order; a flipped rounding
(2^-8 relative) passes through the later products, so per element 4e-2 of
the tensor's largest magnitude and 5e-3 in relative norm. The grouped
matmul: kernel and plain version sum in fp32 and round once, so per element
fp32 2e-5 relative plus 2e-5 times the tensor's largest magnitude where
that exceeds 1 (tgmm sums 4096 rows a group: its rounding is of its partial
sums' size) and bf16 1.6e-2 + 2^-7 |ref|; in norm 1e-5 (fp32) and 2e-3
(bf16).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

H, HD = 12, 64
# the card's memory rate (utils/flops.chip_hbm_bandwidth), set by main()
# from the card's name: a card the table does not know stops the smoke
HBM_BYTES_PER_S = None
TIMED_RUNS = 20
SPIN_CYCLES = 4_000_000            # ~2 ms at the H100's 1.98 GHz boost
FP32_TOL = (2e-5, 2e-5)            # (atol, rtol)
BF16_TOL = (1.6e-2, 2.0 ** -7)
SOURCE = "ddp_practice_tpu_torch/csrc/decode_attention.cu"
FLASH_SOURCE = "ddp_practice_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd_packed": "ddp_practice_tpu/ops/flash_attention.py:541",
    "flash_bwd_packed": "ddp_practice_tpu/ops/flash_attention.py:730",
    "flash_fwd_folded": "ddp_practice_tpu/ops/flash_attention.py:236",
    "flash_bwd_folded": "ddp_practice_tpu/ops/flash_attention.py:375",
}
# row #12: the reference's ablations of kernel E (`pallas_call` sites)
VARIANT_REPLACES = {
    "flash_fwd_v2": "experiments/flash_variants.py:341",
    "flash_fwd_v3": "experiments/flash_variants.py:341",
    "flash_fwd_v4": "experiments/flash_variants.py:307",
    "flash_fwd_v5h2": "experiments/flash_variants.py:216",
    "flash_fwd_v5h4": "experiments/flash_variants.py:216",
    "flash_fwd_nomax": "experiments/flash_ablate.py:72",
    # kernel E's packed route, reached through experiments/flash_4d.fwd4d
    "flash_fwd_4d": "experiments/flash_4d.py:52",
}
# H100 SXM dense peaks (NVIDIA data sheet): bf16 on the tensor cores;
# fp32 runs outside them (the kernels do not use TF32)
PEAK = {"bfloat16": 989.4e12, "float32": 67e12}
# flash: per-element (atol, rtol) for (forward, grads), and the limit on
# each tensor's relative error norm
FLASH_TOL = {"float32": ((2e-5, 2e-5), (1e-4, 1e-4)),
             "bfloat16": (BF16_TOL, BF16_TOL)}
FLASH_REL = {"float32": 1e-5, "bfloat16": 2e-3}
# the sequence phase's ring check holds the flash local (bf16 p, block
# outputs and cotangents, at E/F/G's rounding points) against the plain
# blockwise local, which rounds nothing before its output: in bf16 the
# extra roundings leave 2.3e-3 to 4.4e-3 in relative norm (an H100 run);
# a tile computed wrong moves its elements by their own size (> 1e-1)
RING_REL = {"float32": FLASH_REL["float32"], "bfloat16": 1e-2}
FUSED_SOURCE = "ddp_practice_tpu_torch/csrc/fused_encoder.cu"
FUSED_REPLACES = {
    "fused_encoder_fwd": "ddp_practice_tpu/ops/fused_encoder.py:542",
    "fused_encoder_bwd": "ddp_practice_tpu/ops/fused_encoder.py:584",
}
# fused layer: per-element (forward, grads, causal grads) and relative norm
FUSED_TOL = {"float32": (2e-5, 2e-4, 3e-4), "bfloat16": (4e-2, 4e-2, 4e-2)}
FUSED_REL = {"float32": 1e-5, "bfloat16": 5e-3}
GMM_SOURCE = "ddp_practice_tpu_torch/csrc/grouped_matmul.cu"
GMM_REPLACES = {   # _mb_gmm's megablox gmm, its transposed call, tgmm
    "gmm": "ddp_practice_tpu/ops/moe.py:410",
    "gmm_trhs": "ddp_practice_tpu/ops/moe.py:449",
    "tgmm": "ddp_practice_tpu/ops/moe.py:465",
}
# grouped matmul: per-element (atol, rtol) and the relative error norm
GMM_TOL = {"float32": (2e-5, 2e-5), "bfloat16": BF16_TOL}
GMM_REL = {"float32": 1e-5, "bfloat16": 2e-3}
# lm_moe_tc (bench.py:133-141): lm_base widths, every second of 12 blocks
# routed over 8 experts, top-2, routing groups of 256 strided, cf 1.5
MOE = dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072,
           moe_every=2, num_experts=8, moe_group_size=256,
           capacity_factor=1.5)
MOE_SEQ, MOE_BATCH, MOE_K, MOE_STEPS = 2048, 8, 2, 20
MOE_TOKENS = MOE_SEQ * MOE_BATCH
MOE_HEALTH = ("moe_drop_rate", "moe_load_max", "moe_load_min")
VIT_ARGS = ["--model", "vit_tiny", "--dataset", "cifar10", "--precision",
            "bf16", "-b", "1024", "--optimizer", "adam", "--lr", "1e-4",
            "--synthetic_size", "32768", "-e", "1", "--log_every", "10",
            "--data_dir", "build/no_such_data"]
VIT_STEPS = 30
MODEL_BF16_REL = 1e-2     # a bf16 model step, kernels vs plain versions
# a bf16 run's losses, graph replays vs eager steps: the same kernels on
# the same batches; a cuBLAS algorithm picked apart on the capture stream
# would move a few bf16 roundings
MODEL_BF16_LOSS = 1e-3
TRAIN_ARGS = ["--model", "lm_base", "--attn_impl", "flash", "--precision",
              "bf16", "--optimizer", "adamw", "--lr", "3e-4", "--seq_len",
              "2048", "-b", "8", "-e", "1", "--log_every", "10"]
TRAIN_STEPS = 30
# the reference's config 1 is the CLI's defaults (convnet, mnist, 3
# epochs, batch 32, SGD lr 1e-4, fp32); no MNIST files: the synthetic
# stand-in at MNIST's 60000/10000 images
CONVNET_ARGS = ["--data_dir", "build/no_such_data", "--log_every", "0"]
# ROADMAP A2's legs at the reference bench's shapes (bench.py:78-85):
# ResNet-18 on the synthetic CIFAR-10 set (50000/10000 images, resident),
# ResNet-50 on a synthetic ImageNet corpus cut to 4096/1024 images (on the
# host path, through the native gather); SGD with momentum 0.9 at the lr
# whose loss falls within the leg's steps (experiments/resnet_step.py
# --losses: ResNet-50's rises over 20 steps at 0.05 and 0.2, in fp32 as
# in bf16, and falls at 0.01; ResNet-18's falls at 0.05). The ResNet-50
# leg's loss is little more than its head settling: `resnet50_step_check`
# holds the step itself against float64
RESNET_OPT = ["--optimizer", "sgd", "--momentum", "0.9", "--precision",
              "bf16", "-e", "1", "--log_every", "0"]
RESNET18_ARGS = ["--model", "resnet18", "--dataset", "cifar10", "-b", "512",
                 "--augment", "--max_steps", "30", "--lr", "0.05",
                 "--data_dir", "build/no_such_data"] + RESNET_OPT
RESNET50_ARGS = ["--model", "resnet50", "--dataset", "imagenet", "-b",
                 "128", "--augment", "--augment_kind", "rrc", "--loader",
                 "native", "--max_steps", "20", "--lr", "0.01"] + RESNET_OPT
RESNET50_CORPUS = (4096, 1024)     # train, test images
# ResNet-50 at full width on the card against the host CPU
# (`resnet50_step_check`): the batch; rrc's tolerance (absolute: the fp32
# crop geometry, exp and sqrt of the draws, differs by ulps between the
# card and the host, and a 224-pixel window turns that into up to ~1e-4
# pixels of shift on images whose neighbouring pixels differ by up to 1);
# the train step's (loss relative; logits, running statistics, all grads
# as one vector and each grad leaf in relative error norm) against
# float64 on the host, for float64 and for fp32. The fp32 grads pass
# through 16 BatchNorm backwards, which amplify rounding to some 1e-3; a
# wrong gradient is off by O(1)
RESNET50_CHECK_BATCH = 8
RESNET50_RRC_TOL = 1e-4
RESNET50_STEP_TOL = {
    "float64": dict(loss=1e-6, logits=1e-6, stats=1e-6, grads=1e-6,
                    grads_leaf=1e-6),
    "fp32": dict(loss=1e-5, logits=1e-4, stats=1e-4, grads=1e-2,
                 grads_leaf=5e-2)}
REPLACES = {
    "decode_attention": "ddp_practice_tpu/ops/decode_attention.py:199",
    "decode_attention_int8": "ddp_practice_tpu/ops/decode_attention.py:279",
    "paged_decode_attention":
        "ddp_practice_tpu/ops/decode_attention.py:517",
    "paged_decode_attention_int8":
        "ddp_practice_tpu/ops/decode_attention.py:606",
}
# the serve phase: lm_base under the bf16 policy
SERVE = dict(max_slots=8, max_len=2048, prompt_buckets=(16, 64, 256),
             decode_burst=8, prompt_len_range=(4, 200),
             max_new_range=(8, 64), eos_id=None)
# the router phase (A6a): prompts capped so a failover's prompt + tokens
# so far fits the largest bucket; the fault plan and SLO of its legs
ROUTER = dict(SERVE, prompt_len_range=(4, 160))
ROUTER_PLAN = [
    dict(kind="crash", tick=5, replica=1, down_s=0.1),
    # the first admission after warmup lands in slot 3: warm_engine's
    # three bucket admits cycled slots 0-2 to the back of the free list
    dict(kind="nan_logits", tick=2, replica=0, slot=3),
    dict(kind="admit_fail", tick=3, replica=0),
]
ROUTER_SLO = dict(ttft_p99_s=1.0, tpot_p99_s=0.1, error_rate=0.05,
                  fast_window_s=5.0, slow_window_s=30.0, min_events=3)
# the elastic phase's autoscale leg (A6c-2): the reference's trace shape
# (32-96 new tokens, 2 base chunks, 3 at the 4x step, 7 base) at a base
# rate scaled to lm_base. One worker decodes 8 slots a host-bound step
# (PERF.md section 5: 11-18 ms at 8 slots on an NVIDIA H100 80GB HBM3 at
# 700 W), some 450-700 tokens/s: 4
# requests/s (~256 tokens/s) sits under one worker, the step's 16 (~1000
# tokens/s) over it. The reference's 25/s is sized for its CPU model.
AUTOSCALE = dict(rate_hz=4.0)
# the paged sweep: 2048-position slots over a full-backing pool
BS, MB = 16, 128
NB = 1 + 8 * MB


def log(*args) -> None:
    print(*args, flush=True)


# the card's name and power limit as nvidia-smi prints them, set by main()
# and printed beside each leg's numbers
CARD = ""


def _record_calls(torch, trainer):
    """Wrap the call the trainer's epoch makes (the resident step, or the
    per-batch step on host data): keep each call's loss on the device and
    mark its end with a CUDA event. Returns (losses, ends, steps a call,
    the step's CUDA graph or None, a function that unwraps the step)."""
    name = ("resident_train_step" if trainer.resident_train_step is not None
            else "train_step")
    step = getattr(trainer, name)
    losses, ends = [], []

    def recorded(*args):
        state, metrics = step(*args)
        losses.append(metrics["loss"])
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return state, metrics

    setattr(trainer, name, recorded)
    k = (max(trainer.config.steps_per_call, 1)
         if name == "resident_train_step" else 1)
    return losses, ends, k, getattr(step, "graph", None), \
        lambda: setattr(trainer, name, step)


def _reset_launches(*modules) -> None:
    """Zero each module's wrapper counts and the graph replays' counts."""
    from ddp_practice_tpu_torch.utils import graphs

    for module in modules:
        module.reset_launches()
    graphs.reset_replayed()


def _launches(*counters) -> dict:
    """Each kernel's launches on the run since `_reset_launches`: the
    wrappers' counts (eager calls) plus the graph replays' (a replay
    launches what its captured step launched, utils/graphs.py)."""
    from ddp_practice_tpu_torch.utils import graphs

    return {name: n + graphs.REPLAYED.get(name, 0)
            for c in counters for name, n in c.items()}


def _placement(trainer, graph) -> str:
    """How a leg's steps ran: resident (graph replays) or host."""
    if trainer.resident_train_step is None:
        return "host batches, eager steps"
    return (f"resident, {trainer.config.steps_per_call} step(s) a call, "
            f"{graph.captures} capture(s), {graph.replays} replays")


def _agree(label, host, resident, k, rel):
    """The resident leg's per-call losses (each the last of its k steps)
    against the host leg's steps at relative `rel`; returns (the number
    of steps held, worst relative difference, bit-identical)."""
    n = min(len(resident), len(host) // k)
    worst, exact = 0.0, True
    for i in range(n):
        got, want = resident[i], host[(i + 1) * k - 1]
        diff = abs(got - want) / max(abs(want), 1e-30)
        worst, exact = max(worst, diff), exact and got == want
        if diff > rel:
            raise AssertionError(f"{label}: resident loss {got} at step "
                                 f"{(i + 1) * k} vs host {want}")
    return n * k, worst, exact


def _time_ms(torch, fn, flush, runs=TIMED_RUNS) -> float:
    """Device time of one call of `fn`, median of `runs`. Each call starts
    with a cold L2 and queued behind a ~2 ms spin kernel, so the host has
    enqueued the whole call before the start event fires: the events
    bracket device work, not Python dispatch."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        flush.zero_()   # 64 MB > the 50 MB L2: every launch starts cold
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _profile_summary(prof):
    """utils/xprof's summary of a torch.profiler run's device events (user
    annotations left out: the optimizer's `Optimizer.step#...` range is
    recorded on the device timeline too, and counting it would add the
    span of its kernels a second time); None when it recorded none."""
    from ddp_practice_tpu_torch.utils import xprof

    events = xprof.device_events(prof)
    return xprof.op_summary_events(events) if events else None


def _by_kind(summary, kinds) -> dict:
    """Device us per printed kind: `kinds` maps xprof categories to the
    phase's labels, in print order; every other category is "other"."""
    out = dict.fromkeys(kinds.values(), 0.0)
    out["other"] = 0.0
    for cat, c in summary["categories"].items():
        out[kinds.get(cat, "other")] += c["ps"] / 1e6
    return out


def _device_ops(summary) -> int:
    return sum(c["count"] for c in summary["categories"].values())


def _log_top_ops(summary, steps, top, unit, width):
    """The `top` ops by device time: time and calls per step, name."""
    scale = 1e6 if unit == "us" else 1e9
    for key, ps in sorted(summary["ops"].items(),
                          key=lambda kv: -kv[1])[:top]:
        calls = summary["op_counts"][key]
        log(f"  {ps / scale / steps:9.3f} {unit}/step "
            f"{calls / steps:5.1f} calls/step  {key[1][:width]}")


def _compare(torch, name, got, want, dtype, what):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output: {what}")
    err = (got.float() - want.float()).abs()
    atol, rtol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    if (err > atol + rtol * want.float().abs()).any():
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e}")
    return float(err.max())


# ------------------------------------------------------- kernels A and B
def _inputs(torch, b, L, cur, dtype, quant, seed, full=False):
    """Random attn_start in [0, cur]; `full`: every row starts at 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((b, 1, H * HD), generator=g, device=dev).to(dtype)
    starts = torch.randint(0, cur + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    if full:
        starts.zero_()
    if quant:
        kc = torch.randint(-127, 128, (b, L, H * HD), generator=g,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, L, H * HD), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((b, H, L), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((b, H, L), generator=g, device=dev) * 0.02 + 1e-3
        return q, kc, vc, starts, ks, vs
    kc = torch.randn((b, L, H * HD), generator=g, device=dev).to(dtype)
    vc = torch.randn((b, L, H * HD), generator=g, device=dev).to(dtype)
    return q, kc, vc, starts, None, None


def _bound_ms(q, kc, starts, cur, quant) -> float:
    """HBM bytes the step must move (q and the output once, each valid K
    and V row once, the valid scale entries, attn_start) over the
    card's memory rate (HBM_BYTES_PER_S).
    The arithmetic, ~4 flop per cache element, is far under the card's
    flop-per-byte ridge, so bytes bound it."""
    rows = int((cur + 1 - starts.clamp(max=cur + 1)).sum())
    b = q.shape[0]
    nbytes = 2 * q.numel() * q.element_size()
    nbytes += 2 * rows * H * HD * kc.element_size()
    nbytes += b * 4
    if quant:
        nbytes += 2 * rows * H * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_kernel(torch, F, ops, *, b, L, cur, dtype, quant, flush, seed,
                 full=False):
    q, kc, vc, starts, ks, vs = _inputs(torch, b, L, cur, dtype, quant,
                                        seed, full)
    kw = dict(n_heads=H, k_scale=ks, v_scale=vs)
    name = "decode_attention_int8" if quant else "decode_attention"
    err = _compare(
        torch, name,
        ops.decode_attention_packed(q, kc, vc, cur, starts, impl="kernel",
                                    **kw),
        ops.decode_attention_plain(q, kc, vc, cur, starts, **kw), dtype,
        f"b={b} L={L} cur={cur} {dtype}")
    # the yardstick: SDPA on the same masked problem (int8: on the cache
    # dequantized outside the timed call)
    kd, vd = kc, vc
    if quant:
        kd = (kc.view(b, L, H, HD).float()
              * ks.transpose(1, 2)[..., None]).to(dtype)
        vd = (vc.view(b, L, H, HD).float()
              * vs.transpose(1, 2)[..., None]).to(dtype)
    q4 = q.view(b, 1, H, HD).transpose(1, 2)
    k4 = kd.reshape(b, L, H, HD).transpose(1, 2)
    v4 = vd.reshape(b, L, H, HD).transpose(1, 2)
    pos = torch.arange(L, device="cuda")
    mask = ((pos[None, :] <= cur) & (pos[None, :] >= starts[:, None]))
    mask = mask[:, None, None, :]
    row = {
        "kernel": name, "b": b, "L": L, "cur": cur,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": _time_ms(torch, lambda: ops.decode_attention_packed(
            q, kc, vc, cur, starts, impl="kernel", **kw), flush),
        "plain_ms": _time_ms(torch, lambda: ops.decode_attention_plain(
            q, kc, vc, cur, starts, **kw), flush),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask), flush),
        "bound_ms": _bound_ms(q, kc, starts, cur, quant),
    }
    log(f"  {name:>21} b={b} L={L:5d} cur={cur:5d} {row['dtype']:>8}: "
        f"err {row['max_abs_err']:.2e}  kernel {row['ms'] * 1e3:8.2f} us  "
        f"plain {row['plain_ms'] * 1e3:8.2f} us  "
        f"sdpa {row['library_ms'] * 1e3:8.2f} us  "
        f"bound {row['bound_ms'] * 1e3:7.3f} us")
    return row


def timing_floor(torch, flush) -> float:
    """`_time_ms` of a spin kernel of one cycle: the harness's own floor
    (events, a launch on a cold L2), beside which a kernel of a few us
    is read."""
    ms = _time_ms(torch, lambda: torch.cuda._sleep(1), flush)
    log(f"  timing floor: torch.cuda._sleep(1) through _time_ms "
        f"{ms * 1e3:8.2f} us")
    return ms


def kernel_phase(torch, F, ops, flush) -> dict:
    """Kernels A and B over the sweep and the long rows; returns {kernel:
    the serve-shape row} with max_abs_err raised to the worst row's."""
    worst = {"decode_attention": 0.0, "decode_attention_int8": 0.0}
    seed = 0
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 8):
                for L in (1024, 2048):
                    for cur in (0, L // 2, L - 1):
                        seed += 1
                        row = check_kernel(torch, F, ops, b=b, L=L,
                                           cur=cur, dtype=dtype,
                                           quant=quant, flush=flush,
                                           seed=seed)
                        worst[row["kernel"]] = max(worst[row["kernel"]],
                                                   row["max_abs_err"])
    # long contexts, every key valid (start 0): A and B at 32768, A at
    # 65536 (past the old kernel's shared-memory score buffer)
    for quant, L in ((False, 32768), (True, 32768), (False, 65536)):
        row = check_kernel(torch, F, ops, b=1, L=L, cur=L - 1,
                           dtype=torch.bfloat16, quant=quant, flush=flush,
                           seed=500 + L + quant, full=True)
        worst[row["kernel"]] = max(worst[row["kernel"]], row["max_abs_err"])
    # the serve phase's own shape: 8 slots, a 2048-position pool, bf16
    # queries, the shared cursor a burst past the 256-wide base bucket
    main = {}
    for quant in (False, True):
        row = check_kernel(torch, F, ops, b=8, L=2048, cur=320,
                           dtype=torch.bfloat16, quant=quant, flush=flush,
                           seed=1000 + quant)
        row["max_abs_err"] = max(row["max_abs_err"], worst[row["kernel"]])
        main[row["kernel"]] = row
    return main


# ------------------------------------------------------- kernels C and D
def _sweep_case(np, rng, lengths):
    """Tables of distinct blocks over the full pool, slots 0 and 1 sharing
    their first half, and (b > 2) the last row retired: garbage block 0,
    length 0. Random attn_start in [0, length]."""
    b = len(lengths)
    tables = rng.permutation(np.arange(1, NB))[: b * MB].reshape(b, MB)
    lengths = list(lengths)
    if b > 1:
        tables[1, : MB // 2] = tables[0, : MB // 2]
    starts = [int(rng.integers(0, n + 1)) for n in lengths]
    if b > 2:
        tables[-1] = 0
        lengths[-1] = starts[-1] = 0
    return dict(tables=tables, lengths=lengths, starts=starts, nb=NB)


def _long_case(np, rng, mb):
    """One slot over `mb` distinct blocks of an (mb + 1)-block pool, every
    position valid: length mb * BS - 1, start 0."""
    tables = rng.permutation(np.arange(1, mb + 1))[None, :]
    return dict(tables=tables, lengths=[mb * BS - 1], starts=[0], nb=mb + 1)


def _serve_case(np, rng):
    """The paged serve row's mid-run step: 8 slots, per-slot capacity
    ceil((256 + 64) / 16) = 20 blocks over the bench's 1 + 8*128-block
    pool; each slot a left-padded prompt of 4-200 tokens in its bucket
    and 0-63 tokens decoded."""
    mb = -(-(max(SERVE["prompt_buckets"]) + SERVE["max_new_range"][1])
           // BS)
    free = list(rng.permutation(np.arange(1, NB)))
    tables = np.zeros((8, mb), np.int64)
    lengths, starts = [], []
    for i in range(8):
        p = int(rng.integers(4, 201))
        w = next(w for w in SERVE["prompt_buckets"] if p <= w)
        n = w + int(rng.integers(0, 64))
        nblk = -(-(n + 1) // BS)
        tables[i, :nblk] = [free.pop() for _ in range(nblk)]
        lengths.append(n)
        starts.append(w - p)
    return dict(tables=tables, lengths=lengths, starts=starts, nb=NB)


def _shared_prefix_case(np, rng):
    """The int8 shared-prefix run's step: 8 slots over its 20-block pool,
    the bench's per-slot capacity for that trace, ceil((96 + 128 + 8) /
    16) = 15 blocks; each slot one of two 6-block prefix chains plus a
    private block, 97-104 prompt tokens and 0-7 decoded."""
    tables = np.zeros((8, 15), np.int64)
    lengths = []
    for i in range(8):
        tables[i, :6] = np.arange(1, 7) + 6 * (i % 2)
        tables[i, 6] = 13 + i % 7
        lengths.append(96 + int(rng.integers(1, 9))
                       + int(rng.integers(0, 8)))
    return dict(tables=tables, lengths=lengths, starts=[0] * 8, nb=20)


def _paged_inputs(torch, case, dtype, quant, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(case["lengths"])
    q = torch.randn((b, 1, H * HD), generator=g, device="cuda").to(dtype)
    shape = (case["nb"], BS, H * HD)
    ks = vs = None
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device="cuda",
                           dtype=torch.int8)
        scale_shape = (case["nb"], H, BS)
        ks = torch.rand(scale_shape, generator=g, device="cuda") * 0.02 + 1e-3
        vs = torch.rand(scale_shape, generator=g, device="cuda") * 0.02 + 1e-3
    else:
        kp = torch.randn(shape, generator=g, device="cuda").to(dtype)
        vp = torch.randn(shape, generator=g, device="cuda").to(dtype)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    return (q, kp, vp, i32(case["tables"]), i32(case["lengths"]),
            i32(case["starts"]), ks, vs)


def _paged_bound_ms(torch, q, kp, tables, lengths, starts, quant) -> float:
    """HBM bytes the step must move: q and the output once, the page table
    and the cursors, and each distinct pool row that some slot reads, once
    with its scale entries: the union over slots of (page_table[b, p //
    bs], p % bs) for p in [start_b, min(length_b, capacity - 1)]. Slots
    that share blocks share those rows. Over HBM_BYTES_PER_S."""
    pos = torch.arange(tables.shape[1] * BS, device=tables.device)
    valid = ((pos[None, :] >= starts[:, None].long())
             & (pos[None, :] <= lengths[:, None].long()))
    row_id = (tables.long().repeat_interleave(BS, dim=1) * BS
              + pos[None, :] % BS)
    rows = int(torch.unique(row_id[valid]).numel())
    nbytes = 2 * q.numel() * q.element_size()
    nbytes += 2 * rows * H * HD * kp.element_size()
    nbytes += tables.numel() * 4 + 2 * q.shape[0] * 4
    if quant:
        nbytes += 2 * rows * H * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_paged(torch, F, ops, *, case, dtype, quant, flush, seed, label):
    q, kp, vp, tables, lengths, starts, ks, vs = _paged_inputs(
        torch, case, dtype, quant, seed)
    kw = dict(n_heads=H, k_scale=ks, v_scale=vs)
    args = (q, kp, vp, tables, lengths, starts)
    name = ("paged_decode_attention_int8" if quant
            else "paged_decode_attention")
    err = _compare(
        torch, name, ops.paged_decode_attention(*args, impl="kernel", **kw),
        ops.paged_decode_attention_plain(*args, **kw), dtype,
        f"{label} {dtype}")
    # the yardstick: SDPA over each slot's span, gathered (and for int8
    # dequantized) OUTSIDE the timed call — it skips the gather
    b = q.shape[0]
    k4 = ops.gather_pages(kp, tables, H, ks).to(dtype).transpose(1, 2)
    v4 = ops.gather_pages(vp, tables, H, vs).to(dtype).transpose(1, 2)
    pos = torch.arange(k4.shape[2], device="cuda")
    mask = ((pos[None, :] <= lengths[:, None])
            & (pos[None, :] >= starts[:, None]))[:, None, None, :]
    q4 = q.view(b, 1, H, HD).transpose(1, 2)
    row = {
        "kernel": name, "shape": label,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": _time_ms(torch, lambda: ops.paged_decode_attention(
            *args, impl="kernel", **kw), flush),
        "plain_ms": _time_ms(torch, lambda: ops.paged_decode_attention_plain(
            *args, **kw), flush),
        "library_ms": _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask), flush),
        "bound_ms": _paged_bound_ms(torch, q, kp, tables, lengths, starts,
                                    quant),
    }
    log(f"  {name:>27} {label:<34} {row['dtype']:>8}: "
        f"err {err:.2e}  kernel {row['ms'] * 1e3:8.2f} us  "
        f"plain {row['plain_ms'] * 1e3:8.2f} us  sdpa-pregathered "
        f"{row['library_ms'] * 1e3:8.2f} us  "
        f"bound {row['bound_ms'] * 1e3:7.3f} us")
    return row


def paged_kernel_phase(torch, F, ops, flush) -> dict:
    """Kernels C and D over the sweep and the long rows; returns {kernel:
    main-path row} with max_abs_err raised to the worst row's."""
    import numpy as np

    rng = np.random.default_rng(0)
    top = MB * BS - 1
    cases = [(f"b=1 mb={MB} len={n}", _sweep_case(np, rng, [n]))
             for n in (0, top // 2, top)]
    cases.append((f"b=8 mb={MB} mixed+shared+garbage", _sweep_case(
        np, rng, [top, top // 2, 0, 1500, top, 777, 64, 0])))
    worst = {"paged_decode_attention": 0.0,
             "paged_decode_attention_int8": 0.0}
    seed = 2000
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for label, case in cases:
                seed += 1
                row = check_paged(torch, F, ops, case=case, dtype=dtype,
                                  quant=quant, flush=flush, seed=seed,
                                  label=label)
                worst[row["kernel"]] = max(worst[row["kernel"]],
                                           row["max_abs_err"])
    # long contexts, every position valid: C and D at mb = 2048 (32768
    # positions), C at 4096 (past the old kernel's score buffer)
    for quant, mb in ((False, 2048), (True, 2048), (False, 4096)):
        row = check_paged(torch, F, ops, case=_long_case(np, rng, mb),
                          dtype=torch.bfloat16, quant=quant, flush=flush,
                          seed=2500 + mb + quant,
                          label=f"b=1 mb={mb} len={mb * BS - 1}")
        worst[row["kernel"]] = max(worst[row["kernel"]], row["max_abs_err"])
    main = {}
    for quant, label, case in (
            (False, "serve b=8 mb=20 (paged row)", _serve_case(np, rng)),
            (True, "prefix b=8 mb=15 nb=20 (int8 run)",
             _shared_prefix_case(np, rng))):
        row = check_paged(torch, F, ops, case=case, dtype=torch.bfloat16,
                          quant=quant, flush=flush, seed=3000 + quant,
                          label=label)
        row["max_abs_err"] = max(row["max_abs_err"], worst[row["kernel"]])
        main[row["kernel"]] = row
    return main


# ------------------------------------------------------- kernels E, F, G
def _flash_bound_ms(b, h, sq, sk, d, causal, dtype, elt, backward):
    """The larger of the operations and the bytes over the card's peaks.
    Operations: the products over the (query, key) pairs this causal
    pattern leaves visible (2 flop per multiply-add), 2 products forward
    and 5 backward (qk^T again, p^T.do, do.v^T, ds^T.q, ds.k). Bytes:
    each input read once, each output written once (q, k, v in, out and
    the fp32 lse out; backward q, k, v, o, do, lse in, dq, dk, dv out)."""
    offset = sk - sq if causal else 0
    pairs = sum(min(sk, i + offset + 1) for i in range(sq)) if causal \
        else sq * sk
    flops = (10 if backward else 4) * b * h * pairs * d
    elems = b * h * d * (sq + 2 * sk)
    if backward:
        nbytes = (2 * elems + 2 * b * h * sq * d) * elt + b * h * sq * 4
    else:
        nbytes = (elems + b * h * sq * d) * elt + b * h * sq * 4
    t_ops = flops / PEAK[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _flash_err(torch, name, got, want, dtype, backward, what, rel_limit=None):
    """(max |got - want|, ||got - want|| / ||want||) of one tensor; raises
    past FLASH_TOL element by element or past `rel_limit` (FLASH_REL by
    default) in norm."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output: {what}")
    got, want = got.float(), want.float()
    atol, rtol = FLASH_TOL[dtype][backward]
    err = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    if rel_limit is None:
        rel_limit = FLASH_REL[dtype]
    if (err > atol + rtol * want.abs()).any() or rel > rel_limit:
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e}, relative norm {rel:.3e}")
    return float(err.max()), rel


def check_flash(torch, F, fa, *, label, route, b, h, sq, sk, d, dtype,
                flush, seed, causal=True):
    """E and F+G against the plain versions on one shape and route
    ("qkv": fused-QKV windows, "packed": flat (b, s, h*d), "folded":
    (b, s, h, d) heads that do not pack); the timed calls are the
    launches alone on prepared operands."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    elt = torch.tensor([], dtype=tdt).element_size()
    if route == "qkv":
        qkv = torch.randn((b, sq, 3 * h * d), generator=g,
                          device="cuda").to(tdt)
        w = qkv.unflatten(-1, (3, h, d))
        q4, k4, v4 = (w[:, :, i].transpose(1, 2) for i in range(3))
        inputs = [qkv]

        def entry(x, impl):
            return fa.flash_attention_qkv(x, h, causal=causal, impl=impl)
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=g,
                               device="cuda").to(tdt)
                   for s in (sq, sk, sk))
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        inputs = [q, k, v]

        def entry(*xs, impl):
            return fa.flash_attention(*xs[:3], causal=causal, impl=impl)
    row = "packed" if route in ("qkv", "packed") else "folded"
    assert (fa._heads_per_pack(h, d) is not None) == (row == "packed")
    do = torch.randn((b, sq, h, d), generator=g, device="cuda").to(tdt)
    what = f"{label} {dtype}"

    def run(impl):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = entry(*xs, impl=impl)
        grads = torch.autograd.grad(out, xs, do)
        return out.detach(), grads

    out_k, grads_k = run("kernel")
    out_p, grads_p = run("plain")
    if route == "qkv":           # the (b, s, 3hd) gradient's three windows
        grads_k, grads_p = grads_k[0].chunk(3, -1), grads_p[0].chunk(3, -1)
    err_f, rel_f = _flash_err(torch, "E", out_k, out_p, dtype, False,
                              f"{what} out")
    errs = [_flash_err(torch, "F+G", a, b_, dtype, True, f"{what} {n}")
            for n, a, b_ in zip(("dq", "dk", "dv"), grads_k, grads_p)]
    err_b = max(e for e, _ in errs)
    log(f"  {'E, F+G vs plain':>16} {label:<34} {dtype:>8}: max |err| / "
        f"relative norm: out {err_f:.2e} / {rel_f:.2e}  " + "  ".join(
            f"{n} {e:.2e} / {r:.2e}"
            for n, (e, r) in zip(("dq", "dk", "dv"), errs)))
    # the launches alone, on the forward's own residuals
    out4 = torch.empty_like(q4)
    lse = fa._launch_fwd(q4, k4, v4, out4, causal)
    do4 = do.transpose(1, 2)
    dq4, dk4, dv4 = (torch.empty_like(t) for t in (q4, k4, v4))
    row_f, row_b = f"flash_fwd_{row}", f"flash_bwd_{row}"
    ms_f = _time_ms(torch, lambda: fa._launch_fwd(q4, k4, v4, out4, causal),
                    flush)
    ms_b = _time_ms(torch, lambda: fa._launch_bwd(
        q4, k4, v4, out4, do4, lse, None, dq4, dk4, dv4, causal), flush)
    # G and F apart: each C entry launched alone (F reads the delta and
    # qs G wrote in its warm-up call)
    args = (q4, k4, v4, out4, do4, lse, None, torch.empty_like(lse),
            torch.empty_like(q4, memory_format=torch.contiguous_format),
            dq4, dk4, dv4, causal)
    ms_g = _time_ms(torch, lambda: fa._launch_dq(*args), flush)
    ms_fk = _time_ms(torch, lambda: fa._launch_dkdv(*args), flush)
    plain_f = _time_ms(torch, lambda: fa.flash_attention_plain(
        q4, k4, v4, causal=causal), flush, runs=5)
    plain_b = _time_ms(torch, lambda: fa.flash_attention_plain_bwd(
        q4, k4, v4, out4, do4, lse, causal=causal), flush, runs=5)
    lib_f = lib_b = None
    if sq == sk:
        qs, ks, vs = (t.detach().contiguous().requires_grad_(True)
                      for t in (q4, k4, v4))

        def sdpa_forward():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal)

        lib_f = _time_ms(torch, sdpa_forward, flush)
        ref = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        do4c = do4.contiguous()
        lib_b = _time_ms(torch, lambda: torch.autograd.grad(
            ref, (qs, ks, vs), do4c, retain_graph=True), flush)
    rows = {}
    for name, err, ms, plain, lib, backward in (
            (row_f, err_f, ms_f, plain_f, lib_f, False),
            (row_b, err_b, ms_b, plain_b, lib_b, True)):
        bound, by = _flash_bound_ms(b, h, sq, sk, d, causal, dtype, elt,
                                    backward)
        rows[name] = {"kernel": name, "shape": label, "dtype": dtype,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": bound, "bound_by": by}
        lib_txt = "-" if lib is None else f"{lib:8.3f}"
        log(f"  {name:>16} {label:<34} {dtype:>8}: err {err:.2e}  "
            f"kernel {ms:8.3f} ms  plain {plain:8.3f} ms  sdpa {lib_txt} ms"
            f"  bound {bound:7.3f} ms ({by})")
    log(f"  {'G, F apart':>16} {label:<34} {dtype:>8}: G (dq, delta) "
        f"{ms_g:8.3f} ms  F (dk, dv) {ms_fk:8.3f} ms  G+F {ms_g + ms_fk:8.3f}"
        f" ms  (one backward launch {ms_b:.3f} ms)")
    return rows


def kernel_resources(cuda_build, fa, gm, fe) -> None:
    """The ptxas lines (registers, spill bytes, static shared memory) of
    each instantiated bf16 flash kernel (E, G, F), of kernels J and K and
    of kernel H on Hopper, then their blocks' dynamic shared memory, threads
    and blocks an SM (the runtime's occupancy calculator): E, G and F per
    head_dim, J (the Hopper kernel, `gmm_kernel<BN, TRANS, F32OUT>`) and K
    (`tgmm_wg_kernel<BN, F32OUT>`) per tile width, H
    (`fused_encoder_fwd_wg_kernel<D>`) at the ViT-Tiny and causal LM
    layers."""
    variants = {fa.fwd_kernel_name(64, nh, fa.VARIANTS[v][0])
                for _, v, nh in VARIANT_ROWS}
    for source, prefixes in (("flash_attention", ("flash_fwd_tc_",
                                                  "flash_bwd_")),
                             ("grouped_matmul", ("gmm_kernel<",
                                                 "tgmm_wg_kernel<")),
                             ("fused_encoder", ("fused_encoder_fwd_wg_",))):
        found = cuda_build.kernel_resources(
            cuda_build.ptxas_info.get(source, ""))
        for name, lines in found.items():
            # the variants' lines come with their phase (variant_resources)
            if name.startswith(prefixes) and name not in variants:
                log(f"  ptxas {name}: " + "; ".join(
                    line.split(":", 1)[-1].strip() for line in lines))
    for d in (32, 64, 128, 256):
        occ = fa.occupancy(d)
        log(f"  flash bf16 d={d}: " + "; ".join(
            f"{k} {v['smem_bytes']} B shared x {v['threads']} threads, "
            f"{v['blocks_per_sm']} blocks/SM" for k, v in occ.items()))
    for name, widths, footprint in (("J", gm.GMM_BLOCK_N, gm.gmm_occupancy),
                                    ("K", gm.TGMM_BLOCK_N,
                                     gm.tgmm_occupancy)):
        for block_n in widths:
            occ = footprint(block_n)
            log(f"  grouped matmul {name} bf16 tile 128 x {block_n}: "
                f"{occ['smem_bytes']} B shared x {occ['threads']} threads, "
                f"{occ['blocks_per_sm']} blocks/SM")
    for label, s, d, heads in (("vit_tiny", 64, 192, 3),
                               ("causal lm", 128, 256, 4)):
        occ = fe.wg_occupancy(s, d, heads)
        plan = fe._wg_plan(s, d, heads)
        log(f"  fused encoder H bf16 {label} (s={s}, d={d}): {plan.seqs} "
            f"sequences a {fe.WG_ROWS}-row tile, {plan.stages} ring stages, "
            f"{occ['smem_bytes']} B shared x {occ['threads']} threads, "
            f"{occ['blocks_per_sm']} blocks/SM")


def flash_kernel_phase(torch, F, fa, flush) -> dict:
    """E/F/G over the shapes; returns {row: main-path row} with
    max_abs_err raised to the sweep's worst. The packed rows' main path is
    the lm_base training shape through the fused-QKV windows, the folded
    rows' the folded leg's (24 heads of 32)."""
    worst = {n: 0.0 for n in FLASH_REPLACES}
    main = {}
    cases = [
        ("lm_base train b=8 s=2048 fused-qkv", "qkv", 8, 12, 2048, 2048, 64,
         "bfloat16", True),
        ("lm_base train b=8 s=2048 packed", "packed", 8, 12, 2048, 2048, 64,
         "bfloat16", False),
        ("b=1 s=8192 packed", "packed", 1, 12, 8192, 8192, 64, "bfloat16",
         False),
        ("folded leg b=8 s=2048 h=24 d=32", "folded", 8, 24, 2048, 2048, 32,
         "bfloat16", True),
        ("fp32 b=2 s=512 fused-qkv", "qkv", 2, 12, 512, 512, 64, "float32",
         False),
        ("fp32 b=2 s=512 h=24 d=32", "folded", 2, 24, 512, 512, 32,
         "float32", False),
    ]
    for seed, (label, route, b, h, sq, sk, d, dtype, is_main) in \
            enumerate(cases):
        rows = check_flash(torch, F, fa, label=label, route=route, b=b, h=h,
                           sq=sq, sk=sk, d=d, dtype=dtype, flush=flush,
                           seed=4000 + seed)
        for name, row in rows.items():
            worst[name] = max(worst[name], row["max_abs_err"])
            if is_main:
                main[name] = row
    for name, row in main.items():
        row["max_abs_err"] = worst[name]
    return main


# -------------------------------------------------- kernel E's variants
def _library_flash(torch, F, q, k, v, causal):
    """The library's flash attention (SDPBackend.FLASH_ATTENTION) on (b,
    h, s, d) views: the yardstick of the variant rows."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def run():
        with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    return run


def check_variant(torch, F, fa, *, name, variant, n_heads, causal, q, k, v,
                  flush, v2_lse):
    """One forward variant at lm_base against its plain version on the
    kernel's own 64-key tiles (the same running max): out at the flash
    bf16 limits, lse within 1e-4 (2^-8 where l sums the rounded p); device
    times of the kernel, of the plain version at the reference's blocks
    (512 x 1024, as E's row) and of the library's flash attention; the
    bound. v3 and v5 must compute the sum-fold (l the sum of the rounded
    p), not v2's fp32 sum: their mean |lse error| stays under a tenth of
    the mean |lse| distance between their plain version and plain v2
    (`v2_lse`, the same inputs and tiles)."""
    kw = dict(variant=variant, n_heads=n_heads, causal=causal)
    out, lse = fa.flash_forward_variant(q, k, v, impl="kernel", **kw)
    want, want_lse = fa.flash_forward_variant_plain(q, k, v, block_q=64,
                                                    block_k=64, **kw)
    what = f"{name} lm_base {'causal' if causal else 'non-causal'}"
    err, rel = _flash_err(torch, name, out, want, "bfloat16", False, what)
    lse_err = float((lse - want_lse).abs().max())
    # v3 and v5 sum the rounded p: a p on a bf16 rounding boundary may
    # round the other way on each side, moving l by at most 2^-8 of itself
    if not lse_err <= (2.0 ** -8 if variant in ("v3", "v5") else 1e-4):
        raise AssertionError(f"{name} lse disagrees with its plain version:"
                             f" {what}: max |err| {lse_err:.3e}")
    sumfold = None
    if variant in ("v3", "v5"):
        mean_err = float((lse - want_lse).abs().mean())
        gap = (want_lse - v2_lse).abs()
        sumfold = {"lse_mean_err": mean_err,
                   "v2_gap_mean": float(gap.mean()),
                   "v2_gap_rows_over_1e-4": float((gap > 1e-4).float().mean()),
                   "rows_over_1e-4": float(((lse - want_lse).abs() > 1e-4)
                                           .float().mean())}
        if not mean_err <= 0.1 * sumfold["v2_gap_mean"]:
            raise AssertionError(
                f"{name} does not compute the sum-fold: {what}: mean |lse "
                f"err| {mean_err:.3e} against its plain version, plain "
                f"{variant} vs plain v2 {sumfold['v2_gap_mean']:.3e}")
    bh, s, d = q.shape
    heads = 12
    q4, k4, v4 = (t.view(bh // heads, heads, s, d) for t in (q, k, v))
    bound, by = _flash_bound_ms(bh, 1, s, s, d, causal, "bfloat16", 2, False)
    row = {"kernel": name, "dtype": "bfloat16", "causal": causal,
           "max_abs_err": err, "rel": rel, "lse_err": lse_err,
           "ms": _time_ms(torch, lambda: fa.flash_forward_variant(
               q, k, v, impl="kernel", **kw), flush),
           "plain_ms": _time_ms(torch, lambda: fa.flash_forward_variant_plain(
               q, k, v, **kw), flush, runs=5),
           "library_ms": _time_ms(torch, _library_flash(
               torch, F, q4, k4, v4, causal), flush),
           "bound_ms": bound, "bound_by": by, "sumfold": sumfold}
    log(f"  {name:>16} {'causal' if causal else 'non-causal':>10}: err "
        f"{err:.2e} / {rel:.2e} (lse {lse_err:.1e})  kernel "
        f"{row['ms']:7.3f} ms  plain {row['plain_ms']:7.3f} ms  library "
        f"flash {row['library_ms']:6.3f} ms  bound {bound:6.3f} ms ({by})")
    if sumfold:
        log(f"  {'':>16} {'sum-fold':>10}: mean |lse err| "
            f"{sumfold['lse_mean_err']:.3e} (rows over 1e-4 "
            f"{sumfold['rows_over_1e-4']:.5f}) vs plain {variant} - plain v2 "
            f"{sumfold['v2_gap_mean']:.3e} (rows over 1e-4 "
            f"{sumfold['v2_gap_rows_over_1e-4']:.4f})")
    return row


def check_4d(torch, F, fa, flush):
    """`fwd4d` (kernel E's packed route on the (b, s, h, d) strides of the
    projection's view) against E's plain version on the same view at
    lm_base; times of fwd4d, of the plain version and of the library's
    flash attention on the (b, h, s, d) view. The fold-and-transpose path
    (E on a folded copy) is logged beside: its difference and its time."""
    from ddp_practice_tpu_torch.experiments import flash_4d

    b, s, h, d = 8, 2048, 12, 64
    g = torch.Generator(device="cuda").manual_seed(4200)
    qf, kf, vf = (torch.randn((b, s, h * d), generator=g, device="cuda")
                  .to(torch.bfloat16) for _ in range(3))
    q, k, v = (x.view(b, s, h, d) for x in (qf, kf, vf))
    with torch.no_grad():
        got = flash_4d.fwd4d(q, k, v, impl="kernel")
        want = flash_4d.fwd4d(q, k, v, impl="plain")
        fold_diff = float((flash_4d.path_4d(qf, kf, vf).float()
                           - flash_4d.path_fold(qf, kf, vf).float())
                          .abs().max())
    err, rel = _flash_err(torch, "flash_fwd_4d", got, want, "bfloat16",
                          False, "fwd4d vs E's plain version lm_base")
    bound, by = _flash_bound_ms(b, h, s, s, d, True, "bfloat16", 2, False)
    fold_ms = _time_ms(torch, lambda: flash_4d.path_fold(qf, kf, vf), flush)
    row = {"kernel": "flash_fwd_4d", "dtype": "bfloat16", "causal": True,
           "max_abs_err": err, "rel": rel,
           "ms": _time_ms(torch, lambda: flash_4d.fwd4d(q, k, v), flush),
           "plain_ms": _time_ms(torch, lambda: flash_4d.fwd4d(
               q, k, v, impl="plain"), flush, runs=5),
           "library_ms": _time_ms(torch, _library_flash(
               torch, F, *(t.transpose(1, 2) for t in (q, k, v)), True),
               flush),
           "bound_ms": bound, "bound_by": by}
    log(f"  {'flash_fwd_4d':>16} {'causal':>10}: err {err:.2e} / {rel:.2e}"
        f"  kernel {row['ms']:7.3f} ms  plain {row['plain_ms']:7.3f} ms  "
        f"library flash {row['library_ms']:6.3f} ms  bound {bound:6.3f} ms "
        f"({by}); fold+transpose {fold_ms:.3f} ms, max |4d - fold| "
        f"{fold_diff:.2e}")
    return row


VARIANT_ROWS = (("flash_fwd_v2", "v2", 1), ("flash_fwd_v3", "v3", 1),
                ("flash_fwd_v4", "v4", 2), ("flash_fwd_v5h2", "v5", 2),
                ("flash_fwd_v5h4", "v5", 4), ("flash_fwd_nomax", "nomax", 1))


def variant_resources(cuda_build, fa) -> None:
    """Each variant kernel's ptxas line (registers, spills) and footprint
    (dynamic shared memory, threads, blocks an SM by the occupancy
    calculator)."""
    found = cuda_build.kernel_resources(
        cuda_build.ptxas_info.get("flash_attention", ""))
    for name, variant, n_heads in VARIANT_ROWS:
        kernel = fa.fwd_kernel_name(64, n_heads, fa.VARIANTS[variant][0])
        occ = fa.variant_occupancy(variant, n_heads)
        ptxas = "; ".join(line.split(":", 1)[-1].strip()
                          for line in found.get(kernel, ["not built here"]))
        log(f"  {name:>16} {kernel}: {ptxas}; {occ['smem_bytes']} B shared "
            f"x {occ['threads']} threads, {occ['blocks_per_sm']} blocks/SM")


def variant_phase(torch, F, fa, cuda_build, flush) -> dict:
    """Row #12: each variant kernel's resources; each forward variant and
    fwd4d against its plain version at lm_base (b*h = 96, s = 2048, d =
    64, bf16; v2 causal and not), each variant's time against kernel E's
    on the same operands (folded, causal or not as the row); then the
    slice's main path: the five experiment scripts' `main()` (the
    ablations and the trace-based flash timings) with the launch counts
    zeroed just before and read just after. Returns {row: record} with
    the main path's launches."""
    from ddp_practice_tpu_torch.experiments import (
        flash_4d, flash_ablate, flash_profile, flash_time, flash_variants,
    )

    variant_resources(cuda_build, fa)
    g = torch.Generator(device="cuda").manual_seed(4100)
    q, k, v = (torch.randn((96, 2048, 64), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    _, v2_lse = fa.flash_forward_variant_plain(q, k, v, variant="v2",
                                               block_q=64, block_k=64)
    e_ms = {causal: _time_ms(torch, lambda: fa.flash_attention_with_lse(
        q, k, v, causal=causal, impl="kernel"), flush)
        for causal in (True, False)}
    log(f"  {'E (folded)':>16}: causal {e_ms[True]:7.3f} ms  non-causal "
        f"{e_ms[False]:7.3f} ms (the same operands)")
    rows = {}
    for name, variant, n_heads, causal in (
            ("flash_fwd_v2", "v2", 1, False),
            *((name, variant, n_heads, True)
              for name, variant, n_heads in VARIANT_ROWS)):
        row = check_variant(torch, F, fa, name=name, variant=variant,
                            n_heads=n_heads, causal=causal, q=q, k=k, v=v,
                            flush=flush, v2_lse=v2_lse)
        row["e_ms"] = e_ms[causal]
        log(f"  {'':>16} {'vs E':>10}: {row['ms'] / e_ms[causal]:.3f}x E's "
            f"{e_ms[causal]:.3f} ms")
        if name in rows:   # v2: the causal row, the worse error of both
            row["max_abs_err"] = max(row["max_abs_err"],
                                     rows[name]["max_abs_err"])
        rows[name] = row
    rows["flash_fwd_4d"] = check_4d(torch, F, fa, flush)
    del q, k, v, v2_lse
    t0 = time.monotonic()
    launches = {name: 0 for name in rows}
    for script in (flash_variants, flash_ablate, flash_4d, flash_profile,
                   flash_time):
        short = script.__name__.rsplit(".", 1)[1]
        log(f"experiments.{short}.main():")
        fa.reset_launches()
        script.main()
        for name, n in fa.VARIANT_LAUNCHES.items():
            launches[name] += n
        if script is flash_4d:
            launches["flash_fwd_4d"] = fa.LAUNCHES["flash_fwd_packed"]
        log(f"  {short} launches: variants {dict(fa.VARIANT_LAUNCHES)}, "
            f"E/F/G {dict(fa.LAUNCHES)}")
    log(f"variant path: the five scripts ran in "
        f"{time.monotonic() - t0:.1f} s; the rows' launches {launches}")
    for name, row in rows.items():
        row["launches"] = launches[name]
    return rows


# -------------------------------------------------------------------- serve
def _lm_base(torch, policy, seed=0, **kw):
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model

    return create_model("lm_base", policy=PrecisionPolicy.from_name(policy),
                        device="cuda", seed=seed, vocab_size=256,
                        max_len=SERVE["max_len"], pos_emb="rope", **kw)


def _row_line(r) -> str:
    ttft, lat = r["ttft_s"], r["latency_s"]
    line = (f"  {r['mode']:>12}: {r['tokens_per_sec']:9.1f} tok/s  "
            f"ttft p50/p99 {ttft['p50'] * 1e3:.1f}/{ttft['p99'] * 1e3:.1f} "
            f"ms  latency p50/p99 {lat['p50'] * 1e3:.1f}/"
            f"{lat['p99'] * 1e3:.1f} ms")
    if "tpot_s" in r:
        tpot = r["tpot_s"]
        line += (f"  tpot p50/p99 {tpot['p50'] * 1e3:.2f}/"
                 f"{tpot['p99'] * 1e3:.2f} ms")
    if "preemptions" in r:
        line += (f"  preemptions {r['preemptions']}  kv "
                 f"{r['kv_bytes_per_token']:.0f} B/token")
    return line + f"  decode steps {r['decode_steps']}"


def _check_rows(rows, n_requests, depth, kernel_of):
    """Every request of every row completed, and in each row exactly the
    row's own kernel launched, depth x its decode steps times."""
    for r in rows:
        statuses = r.get("statuses", {"length": r["completions"]})
        if r["completions"] != n_requests or set(statuses) - {"length",
                                                               "eos"}:
            raise AssertionError(
                f"{r['mode']}: requests did not all complete: {statuses}")
        launched = {k: v for k, v in r["kernel_launches"].items() if v}
        want = {kernel_of[r["mode"]]: depth * r["decode_steps"]}
        if launched != want:
            raise AssertionError(
                f"{r['mode']}: launches {launched}, want {want} (depth "
                f"{depth} x {r['decode_steps']} decode steps)")


def serve_phase(torch, ops, *, n_requests, kv_cache_dtype, paged):
    """serve_bench at lm_base bf16; launch counts zeroed around the run."""
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    model = _lm_base(torch, "bf16", kv_cache_dtype=kv_cache_dtype)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    report = serve_bench(model=model, n_requests=n_requests, rate_hz=16.0,
                         seed=0, paged=paged, **SERVE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    flat = ("decode_attention_int8" if kv_cache_dtype == "int8"
            else "decode_attention")
    rows = [report["continuous"], report["static"]]
    kernel_of = {"continuous": flat, "static": flat}
    if paged:
        rows.append(report["paged"])
        kernel_of["paged"] = "paged_decode_attention"
    log(f"serve[{kv_cache_dtype or 'bf16'} cache] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}, "
        f"depth {model.depth}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r in rows:
        log(_row_line(r))
    if paged:
        log(f"  paged/static {report['paged_vs_static']:.2f}x  "
            f"paged/continuous {report['paged_vs_continuous']:.2f}x  "
            f"max servable context {report['paged']['max_servable_context']}")
    _check_rows(rows, n_requests, model.depth, kernel_of)
    del model
    torch.cuda.empty_cache()
    return report, launches


def shared_prefix_phase(torch, ops, *, n_requests, kv_int8):
    """shared_prefix_bench at lm_base bf16 with its undersized pool."""
    from ddp_practice_tpu_torch.serve.bench import shared_prefix_bench

    model = _lm_base(torch, "bf16",
                     kv_cache_dtype="int8" if kv_int8 else None)
    ops.reset_launches()
    t0 = time.monotonic()
    report = shared_prefix_bench(model=model, n_requests=n_requests,
                                 seed=0, kv_int8=kv_int8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    kernel = ("paged_decode_attention_int8" if kv_int8
              else "paged_decode_attention")
    rows = [report["paged"], report["paged_prefix"]]
    pool = report["pool"]
    pc = report["paged_prefix"]["prefix_cache"]
    log(f"shared-prefix[{pool['kv_cache_dtype']} pool, {pool['num_blocks']}"
        f" blocks x {pool['block_size']}] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}")
    for r in rows:
        log(_row_line(r))
    line = (f"  prefix/paged goodput {report['prefix_vs_paged']:.2f}x  "
            f"hit rate {pc['hit_rate']:.3f} (hit/miss tokens "
            f"{pc['hit_tokens']}/{pc['miss_tokens']})")
    if kv_int8:
        line += (f"  kv bytes/token int8 "
                 f"{report['paged_prefix']['kv_bytes_per_token']:.0f} vs "
                 f"fp32 {report['kv_bytes_per_token_f32']:.0f}")
    log(line)
    _check_rows(rows, n_requests, model.depth,
                {"paged": kernel, "paged+prefix": kernel})
    if pc["hit_tokens"] <= 0:
        raise AssertionError("the prefix cache never hit")
    del model
    torch.cuda.empty_cache()
    return report, launches


def spec_phase(torch, ops, *, n_requests):
    """spec_decode_bench at lm_base fp32: greedy speculation must emit the
    plain engine's tokens."""
    from ddp_practice_tpu_torch.serve.bench import spec_decode_bench

    model = _lm_base(torch, "fp32")
    ops.reset_launches()
    t0 = time.monotonic()
    report = spec_decode_bench(model=model, n_requests=n_requests, seed=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    rows = [report["paged"], report["paged_spec"]]
    spec = report["paged_spec"]["spec"]
    log(f"spec[fp32, spec_k {report['spec_k']}] on {report['device']}: "
        f"{n_requests} requests, wall {wall:.1f} s, launches {launches}")
    for r in rows:
        log(_row_line(r))
    log(f"  spec/paged tpot p50 {report['tpot_ratio']:.3f}x  latency p50 "
        f"{report['latency_ratio_p50']:.3f}x  accept rate "
        f"{report['accept_rate']:.3f} ({spec['accepted_tokens']}/"
        f"{spec['drafted_tokens']} drafted tokens, "
        f"{spec['verify_dispatches']} verify dispatches)  token identity "
        f"{report['token_identity']:.3f}")
    kernel = "paged_decode_attention"
    _check_rows(rows, n_requests, model.depth,
                {"paged": kernel, "paged+spec": kernel})
    if report["token_identity"] != 1.0:
        raise AssertionError(
            f"speculative tokens differ from plain paged decode: identity "
            f"{report['token_identity']}")
    del model
    torch.cuda.empty_cache()
    return report, launches


def cross_check(torch):
    """fp32, one fixed schedule (fake clock, every request queued up
    front): the slot engine and the paged engine, each with its kernel
    and with the plain version, emit identical greedy tokens."""
    from ddp_practice_tpu_torch.serve import (
        EngineConfig, FakeClock, PagedEngine, Request, Scheduler,
        SlotEngine,
    )
    from ddp_practice_tpu_torch.serve.bench import build_trace

    model = _lm_base(torch, "fp32", seed=1)
    trace = build_trace(n_requests=8, rate_hz=8.0, vocab=256,
                        prompt_len_range=(4, 60), max_new_range=(8, 32),
                        seed=1)
    cfg = EngineConfig(max_slots=4, max_len=512, prompt_buckets=(16, 64),
                       decode_burst=4, block_size=BS)
    runs = {}
    for engine_cls in (SlotEngine, PagedEngine):
        for impl in ("kernel", "plain"):
            model.set_decode_impl(impl)
            sched = Scheduler(engine_cls(model, cfg), clock=FakeClock(),
                              max_queue=64)
            for t in trace:
                sched.submit(Request(rid=t["rid"], prompt=t["prompt"],
                                     max_new_tokens=t["max_new_tokens"]))
            runs[(engine_cls.__name__, impl)] = {
                c.rid: list(c.tokens) for c in sched.run_until_idle()}
    model.set_decode_impl("auto")
    want = runs[("SlotEngine", "kernel")]
    n = sum(len(v) for v in want.values())
    for key, got in runs.items():
        if got != want:
            diff = [r for r in want if got.get(r) != want[r]]
            raise AssertionError(f"fp32 greedy tokens of {key} differ from "
                                 f"the slot engine's kernel run: rids {diff}")
    log(f"cross-check fp32: slot and paged engines, kernel and plain, "
        f"greedy tokens identical ({len(trace)} requests, {n} tokens)")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------- router (A6a)
def _router_line(r) -> str:
    line = _row_line(r)
    if "retries" in r:
        line += (f"\n                retries {r['retries']:.0f}  failovers "
                 f"{r['failovers']:.0f}  breaker trips "
                 f"{r['breaker_trips']:.0f}  statuses {r['statuses']}  "
                 f"replicas {r['replica_states']}")
    return line


def router_phase(torch, ops):
    """ROADMAP A6a (the docstring's phase 33): serve_bench's router row
    at lm_base, identity under faults in fp32, then the serving rows in
    bf16 with the SLO watchdog and the trace."""
    from ddp_practice_tpu_torch.serve import FaultPlan, FaultSpec
    from ddp_practice_tpu_torch.serve.bench import serve_bench
    from tools.check_traces import validate

    t_phase = time.monotonic()
    plan = FaultPlan([FaultSpec(**s) for s in ROUTER_PLAN])
    n = 12
    flat = "decode_attention"

    def rows_of(report):
        rows = [report["continuous"], report["static"], report["router"]]
        return rows, {r["mode"]: flat for r in rows}

    # leg 1: identity under faults, fp32
    model = _lm_base(torch, "fp32")
    ops.reset_launches()
    t0 = time.monotonic()
    rep = serve_bench(model=model, n_requests=n, rate_hz=16.0, seed=0,
                      replicas=2, fault_plan=plan, collect_tokens=True,
                      **ROUTER)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    rows, kernel_of = rows_of(rep)
    r = rep["router"]
    log(f"router[fp32, x2, faults {json.dumps(ROUTER_PLAN)}] on "
        f"{rep['device']}: {n} requests, wall {time.monotonic() - t0:.1f} "
        f"s, launches {launches} [{CARD}]")
    for row in rows:
        log(_router_line(row))
    _check_rows(rows, n, model.depth, kernel_of)
    want = rep["continuous"]["tokens_by_rid"]
    got = r["tokens_by_rid"]
    diff = [rid for rid in want if got.get(rid) != want[rid]]
    if r["statuses"] != {"length": n} or diff:
        raise AssertionError(f"router under faults: statuses "
                             f"{r['statuses']}, tokens differ from one "
                             f"engine's for rids {diff}")
    if r["failovers"] < 1 or r["retries"] < 2 or r["breaker_trips"] < 1:
        raise AssertionError(
            f"the plan did not bite: failovers {r['failovers']}, retries "
            f"{r['retries']}, breaker trips {r['breaker_trips']}")
    if r["replica_states"][1] != "healthy":
        raise AssertionError(f"replica 1 not back: {r['replica_states']}")
    if r["compile_stats"] != r["warm_compile_stats"]:
        raise AssertionError(f"new shapes after warmup: "
                             f"{r['warm_compile_stats']} -> "
                             f"{r['compile_stats']}")
    n_tok = sum(len(v) for v in got.values())
    log(f"  router x2 under faults, fp32: {n} requests, {n_tok} tokens "
        f"identical to the continuous row's; A launched "
        f"{r['kernel_launches'][flat]} = {model.depth} x "
        f"{r['decode_steps']} decode steps of both replicas")
    total = launches[flat]
    del model, rep
    torch.cuda.empty_cache()

    # leg 2: the serving rows, bf16
    model = _lm_base(torch, "bf16")
    trace_out = "build/router_trace.json"
    os.makedirs("build", exist_ok=True)
    legs = (("x1", dict(replicas=1)), ("x2", dict(replicas=2)),
            ("x2, faults + slo", dict(replicas=2, fault_plan=plan,
                                      slo=json.dumps(ROUTER_SLO),
                                      trace_out=trace_out)))
    for label, kw in legs:
        ops.reset_launches()
        t0 = time.monotonic()
        rep = serve_bench(model=model, n_requests=n, rate_hz=16.0, seed=0,
                          **SERVE, **kw)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        total += launches[flat]
        rows, kernel_of = rows_of(rep)
        log(f"router[bf16, {label}] on {rep['device']}: {n} requests, wall "
            f"{time.monotonic() - t0:.1f} s, launches {launches} [{CARD}]")
        for row in rows:
            log(_router_line(row))
        log(f"  router/continuous tokens/s "
            f"{rep['router_vs_continuous']:.3f}x  goodput "
            f"{rep['router']['goodput_tokens_per_sec']:.1f} tok/s")
        if "slo" in rep["router"]:
            log(f"  slo {json.dumps(ROUTER_SLO)}: alerts "
                f"{json.dumps(rep['router']['slo']['alerts'])}, active at "
                f"the end {rep['router']['slo']['active']}")
        _check_rows(rows, n, model.depth, kernel_of)
    with open(trace_out) as f:
        errors = validate(json.load(f))
    if errors:
        raise AssertionError(f"{trace_out}: {errors[:5]}")
    log(f"  {trace_out}: {rep['trace_events']} events, "
        f"tools/check_traces.py validate clean")
    del model
    torch.cuda.empty_cache()
    log(f"router phase wall {time.monotonic() - t_phase:.1f} s")
    return {flat: total}


# ------------------------------------------------- front door and fleet
def _door_line(r) -> str:
    ttft, lat = r.get("ttft_s") or {}, r.get("latency_s") or {}
    line = (f"  {r['mode']:>36}: {r['goodput_tokens_per_sec']:9.1f} tok/s"
            f"  ttft p50/p99 {ttft.get('p50', 0) * 1e3:.1f}/"
            f"{ttft.get('p99', 0) * 1e3:.1f} ms  latency p50/p99 "
            f"{lat.get('p50', 0) * 1e3:.1f}/{lat.get('p99', 0) * 1e3:.1f} "
            f"ms  lost {r['lost']}  statuses {r['statuses']}")
    if "decode_steps" in r:
        line += f"  decode steps {r['decode_steps']}"
    return line


def _check_door_launches(rows, depth, kernel_of, workers=(),
                         worker_kernel="decode_attention") -> dict:
    """Each in-process row launched only its own kernel, depth x its
    decode steps times; each worker likewise (`worker_kernel`), by its
    own counters. Returns the rows' and the workers' launches, summed
    per kernel."""
    total = {}
    for r in rows:
        launched = {k: v for k, v in r["kernel_launches"].items() if v}
        want = {kernel_of[r["mode"]]: depth * r["decode_steps"]}
        if launched != want:
            raise AssertionError(
                f"{r['mode']}: launches {launched}, want {want} (depth "
                f"{depth} x {r['decode_steps']} decode steps)")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
    for w in workers:
        launched = {k: v for k, v in w["kernel_launches"].items() if v}
        want = {worker_kernel: depth * w["decode_steps"]}
        if launched != want:
            raise AssertionError(
                f"worker {w['replica']} (pid {w['pid']}): launches "
                f"{launched}, want {want} (depth {depth} x "
                f"{w['decode_steps']} of its decode steps)")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
    return total


def _reaped(label) -> None:
    from ddp_practice_tpu_torch.serve.supervisor import reap_all

    leaked = reap_all()
    if leaked:
        raise AssertionError(f"{label}: worker processes outlived their "
                             f"supervisor: {leaked}")


def _ok_statuses(label, statuses) -> None:
    if set(statuses) - {"length", "eos"}:
        raise AssertionError(f"{label}: a stream did not end in a typed "
                             f"ok terminal: {statuses}")


def frontdoor_phase(torch, ops):
    """ROADMAP A6b and A6c-1 (the docstring's phase 34): the HTTP/SSE
    front door, multi-tenant QoS and the supervised worker fleet at
    lm_base, fp32 legs gated, a bf16 fleet leg measured."""
    from ddp_practice_tpu_torch.serve.bench import (
        fleet_bench,
        frontdoor_bench,
        qos_bench,
    )

    t_phase = time.monotonic()
    flat, paged = "decode_attention", "paged_decode_attention"
    door = {k: ROUTER[k] for k in ("max_slots", "max_len", "prompt_buckets",
                                   "prompt_len_range", "max_new_range",
                                   "decode_burst")}
    model = _lm_base(torch, "fp32")
    depth = model.depth
    totals = {flat: 0, paged: 0}

    def add(launched):
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v

    # leg 1: frontdoor_bench, all four arms, fp32
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        fd = frontdoor_bench(model=model, procs=2, n_requests=12,
                             rate_hz=16.0, seed=0, **door)
    finally:
        _reaped("frontdoor_bench")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    cp, sk, sm = fd["chunked_prefill"], fd["sigkill"], fd["sampling"]
    log(f"frontdoor[fp32, procs 2] on {fd['device']}: wall "
        f"{time.monotonic() - t0:.1f} s, launches {launches} [{CARD}]")
    for r in (fd["in_process"], fd["wire"], cp["unchunked"], cp["chunked"],
              sk, sm):
        log(_door_line(r))
    log(f"  wire/in-process goodput {fd['goodput_ratio']:.3f}x  token "
        f"identity {fd['token_identity']:.3f}  --sse audit "
        f"{fd['check_stream']}")
    log(f"  chunked prefill (18 requests, long prompts 720, chunk 32 vs "
        f"0): short-request TTFT p99 "
        f"{cp['chunked']['ttft_short_s']['p99'] * 1e3:.1f} vs "
        f"{cp['unchunked']['ttft_short_s']['p99'] * 1e3:.1f} ms, ratio "
        f"{fd['ttft_p99_ratio_chunked']:.3f}x (reference acceptance <= "
        f"0.85)  identity {cp['token_identity']:.3f}")
    log(f"  SIGKILL of worker 0 at {sk['kill_at_s']} s: lost "
        f"{fd['sigkill_lost']}  resumed markers {sk['resumed_markers']}  "
        f"restarts {sk['worker_restarts']}  audit {sk['check_stream']}  "
        f"workers {json.dumps(sk['workers'])}")
    log(f"  sampling churn: new shapes {fd['sampling_new_compiles']} "
        f"({sm['compile_stats_before']} -> {sm['compile_stats_after']})  "
        f"audit {sm['check_stream']}")
    if fd["token_identity"] != 1.0 or cp["token_identity"] != 1.0:
        raise AssertionError(
            f"front door identity: wire {fd['token_identity']}, chunked "
            f"{cp['token_identity']}")
    if fd["sigkill_lost"] != 0 or sum(sk["worker_restarts"]) < 1:
        raise AssertionError(
            f"SIGKILL arm: lost {fd['sigkill_lost']}, restarts "
            f"{sk['worker_restarts']}")
    for label, r in (("wire", fd["wire"]), ("unchunked", cp["unchunked"]),
                     ("chunked", cp["chunked"]), ("sigkill", sk),
                     ("sampling", sm)):
        _ok_statuses(label, r["statuses"])
    audits = {"wire": fd["check_stream"], "sigkill": sk["check_stream"],
              "sampling": sm["check_stream"],
              "unchunked": cp["unchunked"]["check_stream"],
              "chunked": cp["chunked"]["check_stream"]}
    bad = {k: v for k, v in audits.items() if v.get("ok") is not True}
    if bad:
        raise AssertionError(f"check_stream: {bad}")
    if fd["sampling_new_compiles"] != 0:
        raise AssertionError(f"sampling churn added "
                             f"{fd['sampling_new_compiles']} shapes")
    kernel_of = {fd["in_process"]["mode"]: flat, fd["wire"]["mode"]: flat,
                 sm["mode"]: flat, cp["unchunked"]["mode"]: paged,
                 cp["chunked"]["mode"]: paged}
    rows = (fd["in_process"], fd["wire"], cp["unchunked"], cp["chunked"], sm)
    inproc = _check_door_launches(rows, depth, kernel_of)
    if {k: v for k, v in launches.items() if v} != inproc:
        raise AssertionError(f"leg launches {launches} != the rows' "
                             f"{inproc}")
    add(inproc)
    add(_check_door_launches((), depth, kernel_of, sk["workers"]))
    log(f"  A {inproc.get(flat, 0)} = {depth} x the in-process rows' decode"
        f" steps, C {inproc.get(paged, 0)} = {depth} x the paged rows'; "
        f"each live worker's A = {depth} x its own decode steps")

    # leg 2: qos_bench at the reference's traffic, fp32
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        q = qos_bench(model=model, procs=2)
    finally:
        _reaped("qos_bench")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    qk = q["sigkill"]
    log(f"qos[fp32, procs 2, {json.dumps(q['workload']['duration_s'])} s "
        f"of {sum(t['rate_rps'] for t in q['workload']['tenants']):.0f} "
        f"req/s] on {q['device']}: wall {time.monotonic() - t0:.1f} s, "
        f"launches {launches} [{CARD}]")
    for r in (q["fifo"], q["fair"], qk):
        log(_door_line(r))
        for t, row in r["per_tenant"].items():
            log(f"      {t:>6}: ttft p99 {row['ttft_s']['p99'] * 1e3:.1f} ms"
                f"  window tokens {row['window_tokens']}  "
                f"{row['ok']}/{row['completions']} ok")
    iso = q["isolation_ttft_p99_ratio"]
    log(f"  isolation_ttft_p99_ratio {iso} (reference acceptance <= 0.7)  "
        f"fairness_index {q['fairness_index']:.4f} (>= 0.9)  "
        f"hostile_alert_tripped {q['hostile_alert_tripped']:.0f} (1)  "
        f"compliant_clean {q['compliant_clean']:.0f} (1)")
    log(f"  fair vs FIFO token identity {q['token_identity']:.3f}  SIGKILL "
        f"leg: identity {qk['token_identity']:.3f}, lost {qk['lost']}, "
        f"restarts {qk['worker_restarts']}, fairness "
        f"{qk['fairness_index']:.4f}  workers {json.dumps(qk['workers'])}")
    if q["fifo"]["lost"] or q["fair"]["lost"] or qk["lost"]:
        raise AssertionError(f"qos lost: fifo {q['fifo']['lost']}, fair "
                             f"{q['fair']['lost']}, sigkill {qk['lost']}")
    if q["token_identity"] != 1.0 or qk["token_identity"] != 1.0:
        raise AssertionError(f"qos identity: fair {q['token_identity']}, "
                             f"sigkill {qk['token_identity']}")
    kernel_of = {q["fifo"]["mode"]: flat, q["fair"]["mode"]: flat}
    inproc = _check_door_launches((q["fifo"], q["fair"]), depth, kernel_of)
    if {k: v for k, v in launches.items() if v} != inproc:
        raise AssertionError(f"leg launches {launches} != the rows' "
                             f"{inproc}")
    add(inproc)
    add(_check_door_launches((), depth, kernel_of, qk["workers"]))
    del model
    torch.cuda.empty_cache()

    # leg 3: the fleet against the in-process router, bf16, ungated
    model = _lm_base(torch, "bf16")
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        fl = fleet_bench(model=model, procs=2, reps=2, n_requests=12,
                         rate_hz=16.0, seed=0, **ROUTER)
    finally:
        _reaped("fleet_bench")
    torch.cuda.synchronize()
    ip, fw = fl["in_process"], fl["fleet"]
    log(f"fleet[bf16, procs 2, reps 2] on {fl['device']}: wall "
        f"{time.monotonic() - t0:.1f} s, in-process launches "
        f"{dict(ops.LAUNCHES)} [{CARD}]")
    for r in (ip, fw):
        log(_door_line(r))
    log(f"  fleet x2 / router x2: latency p50 {fl['latency_ratio_p50']:.3f}x"
        f" (per rep {fl['latency_ratio_p50_per_rep']}), goodput "
        f"{fl['goodput_ratio']:.3f}x, tpot p50 {fl['tpot_ratio_p50']:.3f}x, "
        f"ttft p50 {fl['ttft_ratio_p50']:.3f}x; tokens/s "
        f"{fw['goodput_tokens_per_sec']:.1f} vs "
        f"{ip['goodput_tokens_per_sec']:.1f}  workers "
        f"{json.dumps(fw['workers'])} [{CARD}]")
    del model
    torch.cuda.empty_cache()
    log(f"frontdoor phase wall {time.monotonic() - t_phase:.1f} s; A "
        f"{totals[flat]}, C {totals[paged]} over the fp32 legs (in-process "
        f"rows and live workers) [{CARD}]")
    return totals


def _worker_line(workers) -> str:
    return "  ".join(
        f"r{w['replica']} (pid {w['pid']}): {w['decode_steps']} steps, "
        + ", ".join(f"{k} {v}" for k, v in w["kernel_launches"].items() if v)
        for w in workers)


def elastic_phase(torch, ops):
    """ROADMAP A6c-2 (the docstring's phase 35): cache-aware routing over
    paged prefix-caching workers, and the autoscaler with a warm standby,
    at lm_base fp32 through worker processes on this card, gated."""
    from ddp_practice_tpu_torch.serve.bench import (
        cache_routing_bench,
        fleet_autoscale_bench,
    )

    t_phase = time.monotonic()
    flat, paged = "decode_attention", "paged_decode_attention"
    model = _lm_base(torch, "fp32")
    depth = model.depth
    totals = {flat: 0, paged: 0}

    def own_launches(label):
        # the benches decode in the workers only
        torch.cuda.synchronize()
        here = {k: v for k, v in ops.LAUNCHES.items() if v}
        if here:
            raise AssertionError(f"{label}: this process launched {here}")

    # leg 1: cache-aware routing against least-loaded, fp32, greedy
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        cr = cache_routing_bench(model=model, procs=2)
    finally:
        _reaped("cache_routing_bench")
    own_launches("cache_routing_bench")
    aff, ll = cr["affinity"], cr["least_loaded"]
    log(f"cache routing[fp32, procs 2, {cr['trace']['n_requests']} requests "
        f"at {cr['trace']['rate_hz']}/s, {cr['trace']['k_prefixes']} "
        f"prefixes of {cr['trace']['prefix_len']}, pool "
        f"{cr['pool']['num_blocks']} x {cr['pool']['block_size']}, "
        f"{cr['reps']} reps]: wall {time.monotonic() - t0:.1f} s [{CARD}]")
    for r in (ll, aff):
        lat = r["latency_s"]
        log(f"  {r['mode']:>16}: {r['goodput_tokens_per_sec']:9.1f} tok/s  "
            f"hit rate {r['hit_rate']:.4f} ({r['hit_tokens']} hit / "
            f"{r['miss_tokens']} miss tokens)  latency p50/p99 "
            f"{lat['p50'] * 1e3:.1f}/{lat['p99'] * 1e3:.1f} ms  lost "
            f"{r['lost']}")
        log(f"      workers: {_worker_line(r['workers'])}")
    log(f"  affinity / least-loaded: hit rate {cr['hit_rate_ratio']:.4f}x "
        f"(gate > 1)  goodput {cr['goodput_ratio']:.4f}x  token identity "
        f"{cr['token_identity']:.4f} (gate 1)  lost {cr['lost']} (gate 0)"
        f"  routes {aff['route_decisions']}")
    if cr["lost"] != 0 or cr["token_identity"] != 1.0:
        raise AssertionError(f"cache routing: lost {cr['lost']}, token "
                             f"identity {cr['token_identity']}")
    if not cr["hit_rate_ratio"] > 1.0:
        raise AssertionError(f"cache routing: affinity's hit rate is "
                             f"{cr['hit_rate_ratio']}x least-loaded's")
    c = _check_door_launches((), depth, {}, aff["workers"] + ll["workers"],
                             worker_kernel=paged)
    for k, v in c.items():
        totals[k] += v
    log(f"  C {c.get(paged, 0)} = {depth} x each live worker's own decode "
        f"steps")

    # leg 2: the elastic fleet against a fixed one under a 4x step
    ops.reset_launches()
    t0 = time.monotonic()
    try:
        au = fleet_autoscale_bench(model=model, **AUTOSCALE)
    finally:
        _reaped("fleet_autoscale_bench")
    own_launches("fleet_autoscale_bench")
    fx, el = au["fixed"], au["autoscaled"]
    sc = au["autoscale"]
    log(f"autoscale[fp32, {au['rate_hz']}/s -> {au['step_rate_hz']}/s, "
        f"chunks {au['chunks']}, fixed {au['procs_fixed']} vs elastic "
        f"{sc['min']}..{sc['max']} + {sc['standby']} standby]: wall "
        f"{time.monotonic() - t0:.1f} s [{CARD}]")
    for r in (fx, el):
        log(f"  {r['mode']:>10}: {r['goodput_per_worker']:8.2f} tok/s a "
            f"worker ({r['useful_tokens']} tokens over "
            f"{r['worker_seconds']:.2f} worker-s, {r['elapsed_s']:.2f} s)  "
            f"lost {r['lost']}  statuses {r['statuses']}")
        log(f"      workers: {_worker_line(r['workers'])}")
    for e in el["scale_events"]:
        log(f"      scale {e['direction']} ({e['trigger']}) to size "
            f"{e['size']}, slot {e['slot']}, pressure {e['pressure']}"
            + (f", warm {e['warm']}, join {e['join_s'] * 1e3:.3f} ms"
               if e["direction"] == "up" else ""))
    rs = au["reaction_s"]
    log(f"  goodput per worker {au['goodput_per_worker_ratio']:.4f}x fixed "
        f"(recorded)  reaction "
        + ("none" if rs is None else f"{rs:.3f} s")
        + f" (window {au['reaction_window_s']:.2f} s, signal build "
        f"{au['signal_build_s']})  direction changes "
        f"{el['direction_changes']} (bound {el['oscillation_bound']})  "
        f"warm promotion {au['promote_join_s']} s vs cold spawn "
        f"{au['cold_spawn_s']:.3f} s  lost {au['lost']}")
    if au["lost"] != 0 or au["reaction_within_window"] != 1.0 \
            or au["oscillation_ok"] != 1.0:
        raise AssertionError(
            f"autoscale: lost {au['lost']}, reaction_within_window "
            f"{au['reaction_within_window']}, oscillation_ok "
            f"{au['oscillation_ok']}")
    if au["promote_join_s"] is None \
            or not au["promote_join_s"] < au["cold_spawn_s"]:
        raise AssertionError(
            f"autoscale: warm promotion {au['promote_join_s']} s against "
            f"a cold spawn of {au['cold_spawn_s']} s")
    a = _check_door_launches((), depth, {}, fx["workers"] + el["workers"])
    for k, v in a.items():
        totals[k] += v
    log(f"  A {a.get(flat, 0)} = {depth} x each live worker's own decode "
        f"steps")
    del model
    torch.cuda.empty_cache()
    log(f"elastic phase wall {time.monotonic() - t_phase:.1f} s; C "
        f"{totals[paged]} (leg 1), A {totals[flat]} (leg 2) over the live "
        f"workers [{CARD}]")
    return totals


# ------------------------------------------------------------------ profile
def profile_phase(torch, engine_name):
    """One decode step of the serve configuration, every slot busy with a
    200-token prompt: host wall per step from the monotonic clock (bursts
    end in a token readback), device time per step from the kernels a
    torch.profiler trace of two more bursts records."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ddp_practice_tpu_torch.serve import (
        EngineConfig, PagedEngine, SlotEngine,
    )

    engine_cls = {"slot": SlotEngine, "paged": PagedEngine}[engine_name]
    model = _lm_base(torch, "bf16")
    engine = engine_cls(model, EngineConfig(
        max_slots=SERVE["max_slots"], max_len=SERVE["max_len"],
        prompt_buckets=SERVE["prompt_buckets"],
        decode_burst=SERVE["decode_burst"], block_size=BS))
    rng = np.random.default_rng(0)
    slots = [engine.admit(rng.integers(0, model.vocab_size, 200).tolist())
             for _ in range(SERVE["max_slots"])]
    engine.step_burst()                                    # warm
    bursts, k = 2, SERVE["decode_burst"]
    t0 = time.perf_counter()
    for _ in range(bursts):
        engine.step_burst()
    host_ms = (time.perf_counter() - t0) * 1e3 / (bursts * k)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(bursts):
            engine.step_burst()
    summary = _profile_summary(prof)
    steps = bursts * k
    where = (f"cursor {engine.cursor}" if engine_name == "slot" else
             f"slot lengths {sorted({engine.context_len(s) for s in slots})}")
    if summary is None:
        log(f"profile[{engine_name}]: torch.profiler recorded no device "
            f"events; device time not measured (host wall {host_ms:.3f} ms "
            f"per step)")
        return
    by_kind = _by_kind(summary, {"decode A-D": "decode_attention",
                                 "matmul": "matmul"})
    device_ms = sum(by_kind.values()) / 1e3 / steps
    share = {kind: us / 1e3 / steps / device_ms
             for kind, us in by_kind.items()}
    log(f"profile[{engine_name}] (lm_base bf16, {SERVE['max_slots']} busy "
        f"slots, {where}): host wall {host_ms:.3f} ms/step, device busy "
        f"{device_ms:.3f} ms/step, device idle share "
        f"{max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{_device_ops(summary) / steps:.0f} device ops/step; device time "
        f"by kind " + ", ".join(f"{kind} {s:.3f}"
                                for kind, s in share.items()))
    _log_top_ops(summary, steps, 10, "us", 110)
    del engine, model
    torch.cuda.empty_cache()


# -------------------------------------------------------------------- train
def train_phase(torch, fa, extra, *, steps, label, row, metrics_file=None,
                profile_dir=None):
    """`fit` through the CLI's parser and config (lm_base, bf16, AdamW,
    flash) for `steps` steps; each call's loss stays on the device and a
    CUDA event marks its end (no extra readback): a step on host data, a
    group of `--steps_per_call` steps on resident data ("auto" for this
    corpus; each step a replay of the captured step). Checks that the
    loss fell and that `row`'s kernels launched depth x (steps + eval
    batches) forward and depth x steps backward, and nothing else,
    counting the launches graph replays made (`_launches`). With
    `profile_dir`, fit traces its step window (`--profile_dir`): the trace
    is read back with utils/xprof and E, F and G must each appear depth x
    (window steps) times in it; the median step then leaves out the traced
    steps and the one that writes the trace. Returns the trainer (for the
    profile) and the report."""
    import shutil

    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train.loop import Trainer
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        lm_train_flops_per_token,
    )

    argv = TRAIN_ARGS + ["--max_steps", str(steps)] + extra
    if metrics_file:
        argv += ["--metrics_file", metrics_file]
    if profile_dir:
        shutil.rmtree(profile_dir, ignore_errors=True)
        argv += ["--profile_dir", profile_dir]
    config = config_from_args(build_parser().parse_args(argv))
    trainer = Trainer(config)
    losses, ends, k, graph, unwrap = _record_calls(torch, trainer)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unwrap()
    launches = _launches(fa.LAUNCHES)
    loss = [float(x) for x in losses]
    window = trainer._profile_window(0) if profile_dir else None
    traced = set(range(window[0], window[1] + 1)) if window else set()
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i]) / k
                                for i in range(1, len(ends))
                                if i not in traced)
    model = trainer.model
    tokens = trainer.global_batch * config.seq_len
    flops = lm_train_flops_per_token(
        hidden_dim=model.hidden_dim, depth=model.depth,
        mlp_dim=model.mlp_dim, vocab_size=model.vocab_size,
        seq_len=config.seq_len) * tokens
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    eval_batches = len(trainer.eval_loader)
    report = {
        "loss": loss, "step_ms": step_ms, "steps_per_call": k,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / peak if peak else None,
        "accuracy": summary["accuracy"],
        "perplexity": summary["perplexity"],
        "fit_tokens_per_s": summary["tokens_per_sec_per_chip"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "eval_batches": eval_batches, "wall_s": wall,
    }
    shown = [i for i in (1, 10, 20, 30) if i <= len(loss) * k and i % k == 0]
    log(f"train[{label}] {config.model} {config.precision} "
        f"{config.optimizer}, seq {config.seq_len}, batch "
        f"{trainer.global_batch}, {steps} steps + {eval_batches} eval "
        f"batches ({_placement(trainer, graph)}), wall {wall:.1f} s: loss "
        + ", ".join(f"step {i} {loss[i // k - 1]:.4f}" for i in shown))
    mfu = "not measured" if peak is None else f"{report['mfu']:.4f}"
    log(f"  median step {step_ms:.2f} ms (CUDA events between call ends), "
        f"{report['tokens_per_s']:.0f} tokens/s, MFU {mfu} against "
        f"{(peak or 0) / 1e12:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP/step "
        f"analytic); "
        f"fit's own {report['fit_tokens_per_s']:.0f} tokens/s incl. the "
        f"first steps; eval accuracy {report['accuracy']:.4f} perplexity "
        f"{report['perplexity']:.3f}; peak memory "
        f"{report['peak_gib']:.2f} GiB; launches {launches} [{CARD}]")
    if not loss[-1] < loss[0] and len(loss) > 1:
        raise AssertionError(f"train[{label}]: loss did not fall: {loss}")
    want = {n: 0 for n in fa.LAUNCHES}
    want[f"flash_fwd_{row}"] = model.depth * (steps + eval_batches)
    want[f"flash_bwd_{row}"] = model.depth * steps
    if launches != want:
        raise AssertionError(f"train[{label}]: launches {launches}, want "
                             f"{want}")
    if window:
        report["trace"] = _train_trace(profile_dir, window, model.depth, ends)
    return trainer, report


def _train_trace(profile_dir, window, depth, ends):
    """Read fit's `--profile_dir` trace back (utils/xprof.op_summary): one
    trace file; E, F and G depth x (window steps) times each; device time
    per step by category; the traced steps' median beside the others'."""
    import pathlib

    from ddp_practice_tpu_torch.utils import xprof

    files = sorted(pathlib.Path(profile_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile_dir wrote {len(files)} traces")
    summary = xprof.op_summary(profile_dir)
    n = window[1] - window[0]
    cats = summary["categories"]
    counts = {k: cats.get(k, {"count": 0})["count"]
              for k in ("flash E", "flash F", "flash G")}
    if set(counts.values()) != {depth * n}:
        raise AssertionError(f"trace of steps {window}: flash launches "
                             f"{counts}, want {depth * n} each")
    traced_ms = statistics.median(ends[i - 1].elapsed_time(ends[i])
                                  for i in range(window[0] + 1, window[1]))
    log(f"  --profile_dir: {files[0].name} ({files[0].stat().st_size >> 20}"
        f" MiB), steps {window[0]}-{window[1] - 1}; device "
        f"{summary['total_ps'] / 1e9 / n:.2f} ms/step over "
        f"{summary['planes']} stream(s); E/F/G {counts} = {depth} x {n} "
        f"each; by category (ms/step) " + ", ".join(
            f"{k} {c['ps'] / 1e9 / n:.2f}" for k, c in sorted(
                cats.items(), key=lambda kv: -kv[1]["ps"]))
        + f"; traced steps' median {traced_ms:.2f} ms")
    return {"device_ms": summary["total_ps"] / 1e9 / n,
            "traced_step_ms": traced_ms, "counts": counts}


def _model_step(torch, fa, *, precision, attn_impl, impl, seq):
    """One train step's loss and parameter grads of lm_base at depth 2,
    b=2, from seed 3, with every flash entry forced to `impl`."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.losses import cross_entropy

    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 64, (2, seq + 1), generator=g).cuda()
    model = create_model("lm_base", device="cuda", seed=3, depth=2,
                         max_len=seq, vocab_size=64, attn_impl=attn_impl,
                         policy=PrecisionPolicy.from_name(precision))
    fa.reset_launches()
    with fa.forced_impl(impl):
        loss = cross_entropy(model(tokens[:, :-1], train=True),
                             tokens[:, 1:])
        loss.backward()
    torch.cuda.synchronize()
    want = 2 if impl == "kernel" else 0
    if (fa.LAUNCHES["flash_fwd_packed"], fa.LAUNCHES["flash_bwd_packed"]) \
            != (want, want):
        raise AssertionError(f"cross-check {precision} {impl}: launches "
                             f"{fa.LAUNCHES}")
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    del model
    return float(loss.detach()), grads


def train_cross_check(torch, fa):
    """One lm_base train step at depth 2, b=2, with the kernels against
    the same step without them. fp32 at s=512: the kernels, the plain
    versions and attn_impl="xla" give one loss (1e-5) and grads (1e-4
    absolute and relative). bf16 at s=2048 (the tensor-core kernels at
    the training length): the kernels and the plain versions give one
    loss (1e-3 relative) and grads whose error norm stays under
    MODEL_BF16_REL of each grad's norm."""
    runs = {impl: _model_step(torch, fa, precision="fp32", attn_impl=attn,
                              impl=impl, seq=512)
            for attn, impl in (("flash", "kernel"), ("flash", "plain"),
                               ("xla", "auto"))}
    want_loss, want = runs["kernel"]
    worst = 0.0
    for label in ("plain", "auto"):
        got_loss, got = runs[label]
        if abs(got_loss - want_loss) > 1e-5 * max(1.0, abs(want_loss)):
            raise AssertionError(f"cross-check: {label} loss {got_loss} vs "
                                 f"kernel {want_loss}")
        for name, gk in want.items():
            err = (got[name] - gk).abs()
            if (err > 1e-4 + 1e-4 * gk.abs()).any():
                raise AssertionError(f"cross-check: {label} grad {name} "
                                     f"max |err| {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    log(f"cross-check fp32 (lm_base depth 2, s=512, b=2): loss kernel "
        f"{want_loss:.7f} plain {runs['plain'][0]:.7f} xla "
        f"{runs['auto'][0]:.7f}; grads agree, max |err| {worst:.2e}")
    del runs, want
    k_loss, k_grads = _model_step(torch, fa, precision="bf16",
                                  attn_impl="flash", impl="kernel", seq=2048)
    p_loss, p_grads = _model_step(torch, fa, precision="bf16",
                                  attn_impl="flash", impl="plain", seq=2048)
    if abs(k_loss - p_loss) > 1e-3 * abs(p_loss):
        raise AssertionError(f"cross-check bf16: kernel loss {k_loss} vs "
                             f"plain {p_loss}")
    rel = {n: float((k_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in p_grads.items()}
    worst_name = max(rel, key=rel.get)
    if rel[worst_name] > MODEL_BF16_REL:
        raise AssertionError(f"cross-check bf16: grad {worst_name} relative "
                             f"error norm {rel[worst_name]:.3e}")
    log(f"cross-check bf16 (lm_base depth 2, s=2048, b=2): loss kernel "
        f"{k_loss:.7f} plain {p_loss:.7f}; grads' relative error norm "
        f"median {statistics.median(rel.values()):.2e}, worst "
        f"{rel[worst_name]:.2e} ({worst_name})")
    torch.cuda.empty_cache()


def train_profile(torch, trainer):
    """One bf16 lm_base train step under torch.profiler, after warm
    steps: host wall per step (ends in a synchronize), device busy time,
    idle share, device ops per step, E/F/G's share of device time."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(next(iter(trainer.train_loader)))
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    summary = _profile_summary(prof)
    if summary is None:
        log(f"train profile: torch.profiler recorded no device events; "
            f"device time not measured (host wall {host_ms:.2f} ms/step)")
        return
    by_kind = _by_kind(summary, {"flash E": "E", "flash F": "F",
                                 "flash G": "G", "matmul": "matmul"})
    device_ms = sum(by_kind.values()) / 1e3
    log(f"train profile (lm_base bf16 step, b=8, s=2048): host wall "
        f"{host_ms:.2f} ms/step, device busy {device_ms:.2f} ms/step, "
        f"device idle share {max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{_device_ops(summary)} device ops/step; device time by kind "
        + ", ".join(f"{k} {v / 1e3 / device_ms:.3f}"
                    for k, v in by_kind.items()))
    _log_top_ops(summary, 1, 8, "ms", 100)


# ------------------------------------------------------- kernels H and I
def _fused_err(torch, name, got, want, dtype, tol, what):
    """(max |got - want|, relative error norm) of one tensor; raises past
    the per-element tolerance (fp32: tol x max(1, max |want|) absolute plus
    tol relative; bf16: tol x max(1, max |want|)) or FUSED_REL in norm."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name}: {what}")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    limit = tol * scale + (tol * want.abs() if dtype == "float32" else 0.0)
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    if (err > limit).any() or rel > FUSED_REL[dtype]:
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e} (max |ref| {scale:.3e}), relative norm "
            f"{rel:.3e}")
    return float(err.max()), rel


def _fused_bound_ms(imgs, s, d, mlp, dtype, elt, backward):
    """Operations: the layer's 8sd^2 + 4s^2d + 4sd.mlp per sequence forward
    (utils/flops.py's per-layer term), twice that backward (the recompute
    of the forward inside kernel I is counted apart: not here). Bytes:
    forward x in and out once plus the weights once; backward x, g in, dx
    out, the weights in and their fp32 grads out."""
    flops = imgs * (8.0 * s * d * d + 4.0 * s * s * d + 4.0 * s * d * mlp)
    weights = 4 * d * d + 2 * d * mlp + 9 * d + mlp
    if backward:
        flops *= 2.0
        nbytes = 3 * imgs * s * d * elt + weights * (elt + 4)
    else:
        nbytes = 2 * imgs * s * d * elt + weights * elt
    t_ops = flops / PEAK[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_fused(torch, fe, *, label, imgs, s, d, heads, mlp, dtype, causal,
                flush, seed, timed=True):
    """H and I against the plain version on one shape; out, dx and each
    parameter grad held apart. Timed: the wrappers' calls (the casts of
    the weights included), the plain version, and the port's unfused
    EncoderBlock on the same inputs."""
    from ddp_practice_tpu_torch.experiments.fused_profile import inputs
    from ddp_practice_tpu_torch.models.vit import EncoderBlock

    tdt = getattr(torch, dtype)
    x, g, params = inputs(imgs, s, d, mlp, tdt, seed)
    kw = dict(num_heads=heads, compute_dtype=tdt, causal=causal)
    out = fe.fused_encoder_forward(x, params, impl="kernel", **kw)
    dx, grads = fe.fused_encoder_backward(x, g, params, impl="kernel", **kw)
    want_out = fe.fused_encoder_plain(x, params, **kw)
    want_dx, want = fe.fused_encoder_backward_plain(x, g, params, **kw)
    tol_f, tol_g, tol_c = FUSED_TOL[dtype]
    tol_b = tol_c if causal else tol_g
    what = f"{label} {dtype}"
    err_f, rel_f = _fused_err(torch, "H", out, want_out, dtype, tol_f,
                              f"{what} out")
    errs = {"dx": _fused_err(torch, "I", dx, want_dx, dtype, tol_b,
                             f"{what} dx")}
    for name, a, b in zip(fe.PARAM_NAMES, grads, want):
        errs[name] = _fused_err(torch, "I", a, b, dtype, tol_b,
                                f"{what} d({name})")
    worst = max(errs, key=lambda n: errs[n][1])
    err_b = max(e for e, _ in errs.values())
    log(f"  {'H, I vs plain':>17} {label:<30} {dtype:>8}: max |err| / "
        f"relative norm: out {err_f:.2e} / {rel_f:.2e}  dx "
        f"{errs['dx'][0]:.2e} / {errs['dx'][1]:.2e}  worst grad {worst} "
        f"{errs[worst][0]:.2e} / {errs[worst][1]:.2e}")
    if not timed:
        return {}
    # the library column: the port's unfused block, cuBLAS + eager ops
    block = EncoderBlock(d, heads, mlp, dtype=tdt, causal=causal,
                         fused=False).cuda()
    with torch.no_grad():
        for name, value in zip(fe.PARAM_NAMES, params):
            block.get_parameter(name).copy_(value)

    def unfused_forward():
        with torch.no_grad():
            return block(x)

    def unfused_step():
        xs = x.detach().requires_grad_(True)
        return torch.autograd.grad(block(xs), [xs, *block.parameters()], g)

    rows = {}
    for name, err, backward, kernel, plain, lib in (
            ("fused_encoder_fwd", err_f, False,
             lambda: fe.fused_encoder_forward(x, params, impl="kernel", **kw),
             lambda: fe.fused_encoder_plain(x, params, **kw),
             unfused_forward),
            ("fused_encoder_bwd", err_b, True,
             lambda: fe.fused_encoder_backward(x, g, params, impl="kernel",
                                               **kw),
             lambda: fe.fused_encoder_backward_plain(x, g, params, **kw),
             unfused_step)):
        bound, by = _fused_bound_ms(imgs, s, d, mlp, dtype,
                                    x.element_size(), backward)
        rows[name] = {
            "kernel": name, "shape": label, "dtype": dtype,
            "max_abs_err": err, "ms": _time_ms(torch, kernel, flush),
            "plain_ms": _time_ms(torch, plain, flush, runs=5),
            "library_ms": _time_ms(torch, lib, flush),
            "bound_ms": bound, "bound_by": by}
        r = rows[name]
        lib_what = "fwd+bwd" if backward else "fwd"
        log(f"  {name:>17} {label:<30} {dtype:>8}: err {err:.2e}  kernel "
            f"{r['ms']:8.3f} ms  plain {r['plain_ms']:8.3f} ms  unfused "
            f"block {lib_what} {r['library_ms']:8.3f} ms  bound "
            f"{bound:7.3f} ms ({by})")
    if dtype == "bfloat16" and fe._wg_plan(s, d, heads) is not None:
        # the general kernel H that the Hopper kernel replaces here
        general = fe._launch_fwd(x, params, heads, tdt, causal, general=True)
        err_g, _ = _fused_err(torch, "H (general)", general, want_out, dtype,
                              tol_f, f"{what} out")
        general_ms = _time_ms(torch, lambda: fe._launch_fwd(
            x, params, heads, tdt, causal, general=True), flush)
        rows["fused_encoder_fwd"]["general_ms"] = general_ms
        log(f"  {'H, general kernel':>17} {label:<30} {dtype:>8}: err "
            f"{err_g:.2e}  kernel {general_ms:8.3f} ms (the Hopper kernel "
            f"{rows['fused_encoder_fwd']['ms']:.3f})")
    # I's parts: the per-sequence launch with its vector-grad reduction,
    # and the four kernel K launches (each with its second pass)
    args = (x, g, params, heads, tdt, causal)
    _, _, ops, gt = fe._bwd_sequences(*args)
    parts = {"sequences_ms": _time_ms(torch, lambda: fe._bwd_sequences(
                 *args), flush),
             "weight_grads_ms": _time_ms(torch, lambda: fe._bwd_weight_grads(
                 ops, gt), flush)}
    rows["fused_encoder_bwd"].update(parts)
    log(f"  {'I, its parts':>17} {label:<30} {dtype:>8}: per-sequence "
        f"launch {parts['sequences_ms']:8.3f} ms, the four K launches of "
        f"its weight grads {parts['weight_grads_ms']:8.3f} ms")
    return rows


def fused_kernel_phase(torch, fe, flush) -> dict:
    """H and I over the shapes; returns {row: the ViT-Tiny bf16 row} with
    max_abs_err raised to the bf16 cases' worst."""
    cases = [
        # label, imgs, s, d, heads, mlp, dtype, causal, timed, main
        ("vit_tiny 1024x64x192", 1024, 64, 192, 3, 768, "bfloat16", False,
         True, True),
        ("vit_tiny 1024x64x192", 1024, 64, 192, 3, 768, "float32", False,
         True, False),
        ("causal lm 64x128x256", 64, 128, 256, 4, 1024, "bfloat16", True,
         True, False),
        ("causal lm 64x128x256", 64, 128, 256, 4, 1024, "float32", True,
         True, False),
        ("odd batch 7x64x192", 7, 64, 192, 3, 768, "bfloat16", False,
         False, False),
        ("odd batch 7x64x192", 7, 64, 192, 3, 768, "float32", False,
         False, False),
    ]
    main, worst = {}, {}
    for seed, (label, imgs, s, d, heads, mlp, dtype, causal, timed,
               is_main) in enumerate(cases):
        rows = check_fused(torch, fe, label=label, imgs=imgs, s=s, d=d,
                           heads=heads, mlp=mlp, dtype=dtype, causal=causal,
                           flush=flush, seed=6000 + seed, timed=timed)
        for name, row in rows.items():
            if dtype == "bfloat16":
                worst[name] = max(worst.get(name, 0.0), row["max_abs_err"])
            if is_main:
                main[name] = row
    for name, row in main.items():
        row["max_abs_err"] = worst[name]
    return main


# ---------------------------------------------------------------- ViT train
def vit_train_phase(torch, fe, extra, *, steps, label, fused):
    """`fit` through the CLI's parser and config (vit_tiny, bf16, batch
    1024, synthetic CIFAR-10) for `steps` steps and the eval pass. Checks
    that the loss fell and that H launched depth x (steps + eval batches)
    times, I depth x steps and kernel K (with its second pass) 4 x depth x
    steps, I's four weight grads (none with the fused layer off),
    counting the launches graph replays made: with no placement flag the
    corpus is device-resident ("auto") and each step a replay of the
    captured step."""
    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.ops import grouped_matmul as gm
    from ddp_practice_tpu_torch.train.loop import Trainer
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        train_flops_per_image,
    )

    argv = VIT_ARGS + ["--max_steps", str(steps)] + extra
    config = config_from_args(build_parser().parse_args(argv))
    trainer = Trainer(config)
    losses, ends, k, graph, unwrap = _record_calls(torch, trainer)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fe, gm)
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unwrap()
    launches = _launches(fe.LAUNCHES, gm.LAUNCHES)
    loss = [float(x) for x in losses]
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i]) / k
                                for i in range(1, len(ends)))
    model = trainer.model
    flops = train_flops_per_image(
        config.model, trainer.train_ds.image_shape,
        trainer.train_ds.num_classes, patch_size=model.patch_size,
        hidden_dim=model.hidden_dim, depth=model.depth,
        mlp_dim=model.mlp_dim) * trainer.global_batch
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    eval_batches = len(trainer.eval_loader)
    report = {
        "loss": loss, "step_ms": step_ms,
        "images_per_s": trainer.global_batch / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / peak if peak else None,
        "accuracy": summary["accuracy"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches, "eval_batches": eval_batches,
    }
    shown = [i for i in (1, 10, 20, 30) if i <= len(loss)]
    log(f"vit train[{label}] {config.model} {config.precision} "
        f"{config.optimizer} lr {config.learning_rate}, "
        f"{trainer.train_ds.name} {trainer.train_ds.image_shape}, batch "
        f"{trainer.global_batch}, {steps} steps + {eval_batches} eval "
        f"batches ({_placement(trainer, graph)}), wall {wall:.1f} s: loss "
        + ", ".join(f"step {i} {loss[i - 1]:.4f}" for i in shown))
    mfu = "not measured" if peak is None else f"{report['mfu']:.4f}"
    log(f"  median step {step_ms:.2f} ms (CUDA events between step ends), "
        f"{report['images_per_s']:.0f} images/s, MFU {mfu} against "
        f"{(peak or 0) / 1e12:.1f} TFLOP/s ({flops / 1e12:.3f} TFLOP/step "
        f"analytic); fit's own {summary['images_per_sec']:.0f} images/s "
        f"incl. the first steps; eval accuracy {report['accuracy']:.4f}; "
        f"peak memory {report['peak_gib']:.2f} GiB; launches {launches} "
        f"[{CARD}]")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"vit train[{label}]: loss did not fall: {loss}")
    want = {name: 0 for name in launches}
    if fused:
        want.update(fused_encoder_fwd=model.depth * (steps + eval_batches),
                    fused_encoder_bwd=model.depth * steps,
                    tgmm=4 * model.depth * steps,
                    tgmm_reduce=4 * model.depth * steps)
    if launches != want:
        raise AssertionError(f"vit train[{label}]: launches {launches}, "
                             f"want {want}")
    return trainer, report


def vit_train_profile(torch, trainer, label):
    """One bf16 vit_tiny train step under torch.profiler, after warm steps:
    host wall, device busy, idle share, device ops, time by kind."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(next(iter(trainer.train_loader)))
    for _ in range(2):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    summary = _profile_summary(prof)
    if summary is None:
        log(f"vit train profile: torch.profiler recorded no device events; "
            f"device time not measured (host wall {host_ms:.2f} ms/step)")
        return
    by_kind = _by_kind(summary, {"fused H": "H", "fused I": "I",
                                 "grouped K": "I's K",
                                 "fused I reduce": "I reduce",
                                 "matmul": "matmul"})
    device_ms = sum(by_kind.values()) / 1e3
    log(f"vit train profile[{label}] (vit_tiny bf16 step, batch "
        f"{trainer.global_batch}): host wall {host_ms:.2f} ms/step, device "
        f"busy {device_ms:.2f} ms/step, device idle share "
        f"{max(0.0, 1 - device_ms / host_ms):.3f}, {_device_ops(summary)} "
        f"device ops/step; device time by kind "
        + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / 1e3 / device_ms:.3f})"
                    for k, v in by_kind.items()))
    _log_top_ops(summary, 1, 8, "ms", 100)


def _vit_step(torch, fe, *, precision, fused, impl, batch=64):
    """One train step's loss and parameter grads of vit_tiny at depth 2
    from seed 3, the fused layer forced to `impl`."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.losses import cross_entropy

    g = torch.Generator().manual_seed(7)
    images = torch.rand((batch, 32, 32, 3), generator=g).cuda()
    labels = torch.randint(0, 10, (batch,), generator=g).cuda()
    model = create_model("vit_tiny", device="cuda", seed=3, depth=2,
                         fused=fused,
                         policy=PrecisionPolicy.from_name(precision))
    from ddp_practice_tpu_torch.ops import grouped_matmul as gm

    fe.reset_launches()
    gm.reset_launches()
    with fe.forced_impl(impl):
        loss = cross_entropy(model(images, train=True), labels)
        loss.backward()
    torch.cuda.synchronize()
    want = 2 if (fused and impl == "kernel") else 0
    launches = {**fe.LAUNCHES, **gm.LAUNCHES}
    if launches != {"fused_encoder_fwd": want, "fused_encoder_bwd": want,
                    "gmm": 0, "gmm_trhs": 0, "tgmm": 4 * want,
                    "tgmm_reduce": 4 * want}:
        raise AssertionError(f"vit cross-check {precision} fused={fused} "
                             f"{impl}: launches {launches}")
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    del model
    return float(loss.detach()), grads


def vit_cross_check(torch, fe):
    """One vit_tiny train step at depth 2, batch 64. fp32: kernels H and I,
    the fused layer's plain version and the per-op block (`fused=False`)
    give one loss (1e-5) and grads (2e-4, times a grad's largest magnitude
    above 1). bf16: the kernels and the plain version give one loss (1e-3
    relative) and grads whose error norm stays under MODEL_BF16_REL of each
    grad's norm."""
    runs = {label: _vit_step(torch, fe, precision="fp32", fused=fused,
                             impl=impl)
            for label, fused, impl in (("kernel", True, "kernel"),
                                       ("plain", True, "plain"),
                                       ("unfused", False, "auto"))}
    want_loss, want = runs["kernel"]
    worst = 0.0
    for label in ("plain", "unfused"):
        got_loss, got = runs[label]
        if abs(got_loss - want_loss) > 1e-5 * max(1.0, abs(want_loss)):
            raise AssertionError(f"vit cross-check: {label} loss {got_loss} "
                                 f"vs kernel {want_loss}")
        for name, gk in want.items():
            err = (got[name] - gk).abs()
            tol = 2e-4 * max(1.0, float(gk.abs().max()))
            if (err > tol + 2e-4 * gk.abs()).any():
                raise AssertionError(
                    f"vit cross-check: {label} grad {name} max |err| "
                    f"{float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    log(f"vit cross-check fp32 (vit_tiny depth 2, batch 64): loss kernel "
        f"{want_loss:.7f} plain {runs['plain'][0]:.7f} unfused "
        f"{runs['unfused'][0]:.7f}; grads agree, max |err| {worst:.2e}")
    del runs, want
    k_loss, k_grads = _vit_step(torch, fe, precision="bf16", fused=True,
                                impl="kernel")
    p_loss, p_grads = _vit_step(torch, fe, precision="bf16", fused=True,
                                impl="plain")
    if abs(k_loss - p_loss) > 1e-3 * abs(p_loss):
        raise AssertionError(f"vit cross-check bf16: kernel loss {k_loss} vs "
                             f"plain {p_loss}")
    rel = {n: float((k_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in p_grads.items()}
    worst_name = max(rel, key=rel.get)
    if rel[worst_name] > MODEL_BF16_REL:
        raise AssertionError(f"vit cross-check bf16: grad {worst_name} "
                             f"relative error norm {rel[worst_name]:.3e}")
    log(f"vit cross-check bf16 (vit_tiny depth 2, batch 64): loss kernel "
        f"{k_loss:.7f} plain {p_loss:.7f}; grads' relative error norm "
        f"median {statistics.median(rel.values()):.2e}, worst "
        f"{rel[worst_name]:.2e} ({worst_name})")
    torch.cuda.empty_cache()


# ------------------------------------------------------- kernels J and K
def _gmm_bound_ms(m, k, n, e, dtype, e_read=None):
    """2*m*k*n flops over the dtype's peak, against the operands read once
    and the result written once (the same count for all three products:
    (m, k) and (E, k, n) in, (m, n) out, or their transposes). `e_read`
    experts' (k, n) slabs are counted (default all E): a product whose
    empty groups need no weights passes the used groups' count."""
    elt = 2 if dtype == "bfloat16" else 4
    e_read = e if e_read is None else e_read
    t_ops = 2.0 * m * k * n / PEAK[dtype] * 1e3
    t_bytes = ((m * k + e_read * k * n + m * n) * elt + 4 * e) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _gmm_err(torch, name, got, want, dtype, what):
    """(max |err|, relative error norm); raises past GMM_TOL per element
    (fp32: atol times the tensor's largest magnitude where that exceeds 1,
    since a sum over thousands of rows rounds at its partial sums' size)
    or past GMM_REL in norm."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"non-finite {name} output: {what}")
    got, want = got.float(), want.float()
    atol, rtol = GMM_TOL[dtype]
    if dtype == "float32":
        atol *= max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
    if (err > atol + rtol * want.abs()).any() or rel > GMM_REL[dtype]:
        raise AssertionError(
            f"{name} disagrees with its plain version: {what}: max |err| "
            f"{float(err.max()):.3e}, relative norm {rel:.3e}")
    return float(err.max()), rel


def _gmm_library(torch, name, lhs, rhs, grad, gs, want):
    """One PyTorch call computing the same product: torch._grouped_mm where
    this torch takes the operands (and agrees), else a loop of torch.mm
    over the groups. Returns (label, callable)."""
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    calls = {"gmm": lambda: torch._grouped_mm(lhs, rhs, offs=offs),
             "gmm_trhs": lambda: torch._grouped_mm(
                 grad, rhs.transpose(-2, -1), offs=offs),
             "tgmm": lambda: torch._grouped_mm(lhs.t(), grad, offs=offs)}
    try:
        got = calls[name]()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if bool((err <= BF16_TOL[0] + BF16_TOL[1]
                 * want.float().abs()).all()):
            return "torch._grouped_mm", calls[name]
    except (RuntimeError, AttributeError, TypeError):
        pass
    bounds = torch.cat([torch.zeros(1, device="cuda", dtype=torch.int32),
                        offs]).tolist()
    spans = [(e, bounds[e], bounds[e + 1]) for e in range(len(gs))
             if bounds[e + 1] > bounds[e]]

    def loop():
        if name == "tgmm":
            out = torch.zeros_like(want)
            for e, lo, hi in spans:
                torch.mm(lhs[lo:hi].t(), grad[lo:hi], out=out[e])
            return out
        out = torch.empty_like(want)
        for e, lo, hi in spans:
            w = rhs[e].t() if name == "gmm_trhs" else rhs[e]
            src = grad if name == "gmm_trhs" else lhs
            torch.mm(src[lo:hi], w, out=out[lo:hi])
        return out
    return "torch.mm loop", loop


def check_gmm(torch, gm, *, label, sizes, k, n, dtype, flush, seed,
              timed):
    """J forward, J transposed and K against their plain versions on one
    group-size pattern over m = sum(sizes) rows at (k, n): the forward is
    (m, k) x (E, k, n), the transposed (m, n) x (E, k, n)^T, tgmm (m, k)^T
    (m, n) per group. `timed` adds kernel, plain and library device
    times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tdt = getattr(torch, dtype)
    m, e = sum(sizes), len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = torch.randn((m, k), generator=g, device="cuda").to(tdt)
    rhs = (torch.randn((e, k, n), generator=g, device="cuda")
           * k ** -0.5).to(tdt)
    grad = torch.randn((m, n), generator=g, device="cuda").to(tdt)
    runs = {"gmm": (lambda impl: gm.gmm(lhs, rhs, gs, impl=impl)),
            "gmm_trhs": (lambda impl: gm.gmm(grad, rhs, gs,
                                            transpose_rhs=True, impl=impl)),
            "tgmm": (lambda impl: gm.tgmm(lhs, grad, gs, impl=impl))}
    rows = {}
    for name, run in runs.items():
        want = run("plain")
        got = run("kernel")
        err, rel = _gmm_err(torch, name, got, want, dtype,
                            f"{label} {dtype}")
        row = {"kernel": name, "shape": label, "dtype": dtype,
               "max_abs_err": err, "rel": rel}
        if name == "tgmm":
            empty = [i for i, s in enumerate(sizes) if s == 0]
            if empty and got[empty].abs().max() != 0:
                raise AssertionError(f"tgmm: an empty group's grad is not "
                                     f"zero ({label})")
            if dtype == "bfloat16":   # fp32 output, as I's weight grads
                f32 = torch.float32
                err32, rel32 = _gmm_err(
                    torch, "tgmm fp32 out",
                    gm.tgmm(lhs, grad, gs, out_dtype=f32, impl="kernel"),
                    gm.tgmm(lhs, grad, gs, out_dtype=f32, impl="plain"),
                    "float32", f"{label} bf16 -> fp32")
                log(f"  {'tgmm':>8} {label:<40} {'-> fp32':>8}: err "
                    f"{err32:.2e} rel {rel32:.2e}")
        if timed:
            bound, by = _gmm_bound_ms(m, k, n, e, dtype)
            lib_name, lib = ((None, None) if dtype != "bfloat16" else
                             _gmm_library(torch, name, lhs, rhs, grad, gs,
                                          want))
            row.update(
                ms=_time_ms(torch, lambda: run("kernel"), flush),
                plain_ms=_time_ms(torch, lambda: run("plain"), flush),
                library_ms=None if lib is None else _time_ms(torch, lib,
                                                             flush),
                library=lib_name, bound_ms=bound, bound_by=by)
        rows[name] = row
        times = ("" if not timed else
                 f"  kernel {row['ms']:7.3f} ms  plain {row['plain_ms']:7.3f}"
                 f" ms  library {row['library_ms'] or 0:7.3f} ms "
                 f"({row['library']})  bound {row['bound_ms']:.3f} ms "
                 f"({row['bound_by']}), {2 * m * k * n / row['ms'] / 1e9:.1f}"
                 f" TFLOP/s")
        log(f"  {name:>8} {label:<40} {dtype:>8}: err {err:.2e} rel "
            f"{rel:.2e}{times}")
    return rows


def gmm_kernel_phase(torch, gm, flush) -> dict:
    """J and K at the lm_moe shapes (m = 32768 sorted rows, E = 8): the
    w_in products ((k, n) = (768, 3072)) and the w_out ones ((3072, 768)),
    balanced, skewed, with empty experts and boundaries off every tile
    grid, bf16, plus fp32 at the w_in shape. Returns {kernel: the balanced
    bf16 w_in row (the main path's shape)} with max_abs_err raised to the
    sweep's worst."""
    m, e = MOE_TOKENS * MOE_K, MOE["num_experts"]
    patterns = {
        "balanced": [m // e] * e,
        "skewed": [16384, 8192, 4096, 2048, 1024, 512, 256, 256],
        "empty off-grid": [0, 9001, 0, 7777, 1, 0, 15000, 989],
    }
    worst, main = {n: 0.0 for n in GMM_REPLACES}, {}
    seed = 6000
    for pattern, sizes in patterns.items():
        assert sum(sizes) == m
        for k, n in ((768, 3072), (3072, 768)):
            for dtype in ("bfloat16", "float32"):
                if dtype == "float32" and (pattern != "balanced"
                                           or k != 768):
                    continue
                seed += 1
                timed = pattern in ("balanced", "skewed")
                rows = check_gmm(
                    torch, gm, label=f"{pattern} m={m} k={k} n={n}",
                    sizes=sizes, k=k, n=n, dtype=dtype, flush=flush,
                    seed=seed, timed=timed)
                for name, row in rows.items():
                    worst[name] = max(worst[name], row["max_abs_err"])
                    if (pattern == "balanced" and dtype == "bfloat16"
                            and k == 768):
                        main[name] = row
    for name, row in main.items():
        row["max_abs_err"] = worst[name]
    return main


# ---------------------------------------------------------------- MoE train
def _moe_model(torch, *, impl, precision="bf16", seed=0, vocab=64, **kw):
    """lm_moe at the lm_moe_tc configuration (lm_base widths) through the
    registry, its routed layers switched to `impl`."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.moe import moe_layers

    model = create_model("lm_moe", policy=PrecisionPolicy.from_name(
        precision), device="cuda", seed=seed, vocab_size=vocab,
        max_len=MOE_SEQ, attn_impl="flash", **{**MOE, **kw})
    for layer in moe_layers(model):
        layer.impl = impl
    return model


def _moe_loaders(batch=MOE_BATCH, seq=MOE_SEQ):
    """fit's LM batches (train/loop.py _build_lm_data) of `batch` rows of
    `seq` tokens: the synthetic Markov corpus, the last 10% the eval
    split."""
    from ddp_practice_tpu_torch.data.lm_corpus import (
        LMDataLoader,
        TokenCorpus,
        synthetic_token_corpus,
    )

    corpus = synthetic_token_corpus(600000, seed=3407)
    batch_tokens = batch * (seq + 1)
    n_eval = max(len(corpus) - int(len(corpus) * 0.9), batch_tokens)
    split = len(corpus) - n_eval
    make = [TokenCorpus(corpus.tokens[:split], corpus.vocab_size),
            TokenCorpus(corpus.tokens[split:], corpus.vocab_size)]
    return corpus.vocab_size, [
        LMDataLoader(c, seq_len=seq, global_batch_size=batch,
                     seed=3407, shuffle=shuffle)
        for c, shuffle in zip(make, (True, False))]


def _device_batch(torch, np, batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .cuda(non_blocking=True).long() for k, v in batch.items()}


def moe_train_phase(torch, fa, gm, *, impl, steps, label):
    """lm_moe at lm_base widths (the lm_moe_tc configuration: 12 layers, 6
    routed, 8 experts, top-2, routing groups of 256 strided, capacity 1.5,
    seq 2048, batch 8, bf16, AdamW lr 3e-4, flash attention) for `steps`
    steps plus the eval batches, through the optimizer, steps and batches
    `fit` uses. Returns (report, model, state, step, a device batch)."""
    import numpy as np

    from ddp_practice_tpu_torch.config import TrainConfig
    from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
    from ddp_practice_tpu_torch.train.steps import (
        make_lm_eval_step,
        make_lm_train_step,
    )
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        lm_train_flops_per_token,
    )

    vocab, (train_loader, eval_loader) = _moe_loaders()
    model = _moe_model(torch, impl=impl, vocab=vocab)
    config = TrainConfig(model="lm_moe", optimizer="adamw",
                         learning_rate=3e-4, seq_len=MOE_SEQ,
                         batch_size=MOE_BATCH, precision="bf16", epochs=1)
    state = TrainState(step=0, model=model, optimizer=make_optimizer(
        config, model, len(train_loader)))
    step = make_lm_train_step(model, seed=config.seed)
    eval_step = make_lm_eval_step(model)
    batches = [_device_batch(torch, np, b) for _, b in zip(
        range(steps), train_loader)]
    evals = [_device_batch(torch, np, b) for b in eval_loader]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    gm.reset_launches()
    losses, health, ends = [], [], []
    t0 = time.monotonic()
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        health.append([metrics[k] for k in MOE_HEALTH])
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    sums = torch.zeros(3, device="cuda")
    for batch in evals:
        sums += torch.stack(eval_step(state, batch))
    correct, total, nll = sums.tolist()
    wall = time.monotonic() - t0
    launches = {**fa.LAUNCHES, **gm.LAUNCHES}
    loss = [float(x) for x in losses]
    health = [[float(x) for x in h] for h in health]
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i])
                                for i in range(1, len(ends)))
    tokens = MOE_BATCH * MOE_SEQ
    flops = lm_train_flops_per_token(
        hidden_dim=model.hidden_dim, depth=model.depth,
        mlp_dim=model.mlp_dim, vocab_size=vocab, seq_len=MOE_SEQ,
        moe_every=model.moe_every, moe_top_k=model.moe_top_k) * tokens
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    report = {"loss": loss, "step_ms": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "mfu": flops / (step_ms / 1e3) / peak if peak else None,
              "health": dict(zip(MOE_HEALTH, health[-1])),
              "accuracy": correct / max(total, 1.0),
              "perplexity": math.exp(min(nll / max(total, 1.0), 30.0)),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches": launches, "eval_batches": len(evals)}
    mfu = "not measured" if peak is None else f"{report['mfu']:.4f}"
    log(f"moe train[{label}] lm_moe (d=768, depth 12, 6 routed x 8 experts "
        f"top-2, groups of 256 strided, cf 1.5) bf16 adamw, seq {MOE_SEQ}, "
        f"batch {MOE_BATCH}, {steps} steps + {len(evals)} eval batches, "
        f"wall {wall:.1f} s: loss " + ", ".join(
            f"step {i} {loss[i - 1]:.4f}" for i in (1, 10, 20)
            if i <= len(loss)))
    log(f"  median step {step_ms:.2f} ms (CUDA events between step ends), "
        f"{report['tokens_per_s']:.0f} tokens/s, MFU {mfu} over active "
        f"FLOPs ({flops / 1e12:.2f} TFLOP/step analytic); last step "
        + ", ".join(f"{k} {v:.4f}" for k, v in report["health"].items())
        + f"; eval accuracy {report['accuracy']:.4f} perplexity "
        f"{report['perplexity']:.3f}; peak memory {report['peak_gib']:.2f} "
        f"GiB; launches {launches}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"moe train[{label}]: loss did not fall: {loss}")
    n_moe, depth = model.depth // model.moe_every, model.depth
    want = {n: 0 for n in launches}
    want["flash_fwd_packed"] = depth * (steps + len(evals))
    want["flash_bwd_packed"] = depth * steps
    if impl == "sorted":
        want["gmm"] = 2 * n_moe * (steps + len(evals))
        want["gmm_trhs"] = 2 * n_moe * steps
        want["tgmm"] = want["tgmm_reduce"] = 2 * n_moe * steps
        drops = [h[MOE_HEALTH.index("moe_drop_rate")] for h in health]
        if any(d != 0.0 for d in drops):
            raise AssertionError(f"moe train[{label}]: drop rate {drops}")
    if launches != want:
        raise AssertionError(f"moe train[{label}]: launches {launches}, "
                             f"want {want}")
    return report, model, state, step, batches[-1]


def moe_profile(torch, state, step, batch, label):
    """One lm_moe step under torch.profiler after the run: host wall per
    step, device busy, idle share, device time by kind (J, K, the flash
    kernels, cuBLAS, other)."""
    from torch.profiler import ProfilerActivity, profile

    n = 2
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    summary = _profile_summary(prof)
    if summary is None:
        log(f"moe profile[{label}]: torch.profiler recorded no device "
            f"events; device time not measured (host wall {host_ms:.2f} "
            f"ms/step)")
        return
    by_kind = _by_kind(summary, {"grouped J": "J", "grouped K": "K",
                                 "flash E": "flash", "flash F": "flash",
                                 "flash G": "flash", "matmul": "matmul"})
    device_ms = sum(by_kind.values()) / 1e3
    log(f"moe profile[{label}] (lm_moe bf16 step, b=8, s=2048): host wall "
        f"{host_ms:.2f} ms/step, device busy {device_ms:.2f} ms/step, "
        f"device idle share {max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{_device_ops(summary)} device ops/step; device ms by kind "
        + ", ".join(f"{k} {v / 1e3:.2f}" for k, v in by_kind.items()))
    _log_top_ops(summary, 1, 6, "ms", 100)


def moe_cli_phase(torch):
    """`fit` through the CLI's parser for lm_moe at the registry's dims
    with expert-choice routing: the loop's num_experts/moe_router wiring
    and the summary's moe_* keys."""
    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train.loop import Trainer

    argv = ["--model", "lm_moe", "--moe_router", "expert_choice",
            "--precision", "bf16", "--seq_len", "512", "-b", "8", "-e", "1",
            "--max_steps", "10", "--optimizer", "adamw", "--lr", "1e-3",
            "--log_every", "0", "--synthetic_size", "200000"]
    trainer = Trainer(config_from_args(build_parser().parse_args(argv)))
    summary = trainer.fit()
    keys = ("moe_load_max", "moe_load_min", "moe_drop_rate")
    missing = [k for k in keys if k not in summary]
    log(f"moe cli: {' '.join(argv)}: {summary['steps']} steps, "
        f"{summary['tokens_per_sec_per_chip']:.0f} tokens/s (fit's own), "
        f"eval accuracy {summary['accuracy']:.4f} perplexity "
        f"{summary['perplexity']:.3f}, "
        + ", ".join(f"{k} {summary.get(k, float('nan')):.4f}" for k in keys))
    moe = trainer.model.blocks[1].moe
    if missing or moe.router_kind != "expert_choice" \
            or moe.capacity_factor != 1.0:
        raise AssertionError(f"moe cli: summary {summary}, router "
                             f"{moe.router_kind} cf {moe.capacity_factor}")
    del trainer
    torch.cuda.empty_cache()


def _moe_step(torch, gm, *, precision, impl, gmm_impl, seq):
    """One lm_moe train step at lm_base widths, depth 2 (one routed
    block), b=2, capacity factor E/k (the einsum path drops nothing), from
    seed 3: (loss, {name: grad})."""
    from ddp_practice_tpu_torch.ops.losses import cross_entropy
    from ddp_practice_tpu_torch.ops.moe import moe_layers

    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 64, (2, seq + 1), generator=g).cuda()
    model = _moe_model(torch, impl=impl, precision=precision, seed=3,
                       depth=2, capacity_factor=MOE["num_experts"] / MOE_K)
    gm.reset_launches()
    with gm.forced_impl(gmm_impl):
        loss = cross_entropy(model(tokens[:, :-1], train=True),
                             tokens[:, 1:])
        loss = loss + sum(m.sown["moe_aux_loss"] for m in moe_layers(model))
        loss.backward()
    torch.cuda.synchronize()
    want = 2 if (impl, gmm_impl) == ("sorted", "kernel") else 0
    # K's second pass runs where a workspace slab exists: always for the
    # ring-less fp32 K, for the bf16 one only when the m = 2 x seq x k
    # sorted rows exceed one work unit (gm.tgmm_ws_slabs; both products
    # have 72 output tiles of 128 x 256)
    m = 2 * seq * MOE_K
    split = precision == "fp32" or m > gm.tgmm_chunk(
        m, 6 * 12, torch.cuda.get_device_properties(0).multi_processor_count)
    if dict(gm.LAUNCHES) != {"gmm": want, "gmm_trhs": want, "tgmm": want,
                             "tgmm_reduce": want if split else 0}:
        raise AssertionError(f"moe cross-check {precision} {impl} "
                             f"{gmm_impl}: launches {gm.LAUNCHES}")
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    del model
    return float(loss.detach()), grads


def moe_cross_check(torch, gm):
    """fp32 at s=512: the einsum path, the sorted path on kernels J and K
    and the sorted path on their plain versions give one loss (2e-5) and
    one set of grads (5e-4 absolute and relative; the reference's
    tests/test_moe.py:338-351). bf16 at s=2048: kernels vs plain versions,
    loss within 1e-3 relative, each grad's error norm within MODEL_BF16_REL
    of its norm."""
    runs = {label: _moe_step(torch, gm, precision="fp32", impl=impl,
                             gmm_impl=gmm_impl, seq=512)
            for label, impl, gmm_impl in (("kernel", "sorted", "kernel"),
                                          ("plain", "sorted", "plain"),
                                          ("einsum", "einsum", "auto"))}
    want_loss, want = runs["kernel"]
    worst = 0.0
    for label in ("plain", "einsum"):
        got_loss, got = runs[label]
        if abs(got_loss - want_loss) > 2e-5 * max(1.0, abs(want_loss)):
            raise AssertionError(f"moe cross-check: {label} loss {got_loss}"
                                 f" vs kernel {want_loss}")
        for name, gk in want.items():
            err = (got[name] - gk).abs()
            if (err > 5e-4 + 5e-4 * gk.abs()).any():
                raise AssertionError(f"moe cross-check: {label} grad {name}"
                                     f" max |err| {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    log(f"moe cross-check fp32 (lm_moe d=768 depth 2, s=512, b=2, cf "
        f"{MOE['num_experts'] / MOE_K:g}): loss sorted-kernel "
        f"{want_loss:.7f} sorted-plain {runs['plain'][0]:.7f} einsum "
        f"{runs['einsum'][0]:.7f}; grads agree, max |err| {worst:.2e}")
    del runs, want
    k_loss, k_grads = _moe_step(torch, gm, precision="bf16", impl="sorted",
                                gmm_impl="kernel", seq=MOE_SEQ)
    p_loss, p_grads = _moe_step(torch, gm, precision="bf16", impl="sorted",
                                gmm_impl="plain", seq=MOE_SEQ)
    if abs(k_loss - p_loss) > 1e-3 * abs(p_loss):
        raise AssertionError(f"moe cross-check bf16: kernel loss {k_loss} "
                             f"vs plain {p_loss}")
    rel = {n: float((k_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in p_grads.items()}
    worst_name = max(rel, key=rel.get)
    if rel[worst_name] > MODEL_BF16_REL:
        raise AssertionError(f"moe cross-check bf16: grad {worst_name} "
                             f"relative error norm {rel[worst_name]:.3e}")
    log(f"moe cross-check bf16 (lm_moe d=768 depth 2, s={MOE_SEQ}, b=2): "
        f"loss kernel {k_loss:.7f} plain {p_loss:.7f}; grads' relative "
        f"error norm median {statistics.median(rel.values()):.2e}, worst "
        f"{rel[worst_name]:.2e} ({worst_name})")
    torch.cuda.empty_cache()


# ------------------------------------------------------ ConvNet / MNIST
PAR_ARGS = ["--model", "lm_base", "--attn_impl", "flash", "--precision",
            "fp32", "--optimizer", "sgd", "--lr", "1e-2", "--momentum",
            "0.9", "--clip_norm", "1.0", "--seq_len", "2048", "-e", "1",
            "--max_steps", "3", "--data_placement", "host", "--log_every",
            "0"]
PAR_LOSS_RTOL, PAR_RTOL, PAR_ATOL = 2e-4, 1e-3, 1e-5
PAR_LEGS = [("tensor 2", ["--tensor", "2", "-b", "4"], 2),
            ("fsdp over data 2", ["--fsdp", "-b", "2"], 2),
            ("tensor 2 x fsdp data 2", ["--tensor", "2", "--fsdp", "-b",
                                        "2"], 4)]
PAR_NEW_TOKENS = 32
# the sequence phase's legs: (label, flags, ranks); global batch 4 each
SEQ_LEGS = [("seq 2 ring", ["--seq", "2", "--sp_impl", "ring", "-b", "4"],
             2),
            ("seq 4 ring", ["--seq", "4", "--sp_impl", "ring", "-b", "4"],
             4),
            ("seq 2 ulysses", ["--seq", "2", "--sp_impl", "ulysses", "-b",
                               "4"], 2),
            ("tensor 2 x seq 2 ulysses", ["--tensor", "2", "--seq", "2",
                                          "--sp_impl", "ulysses", "-b",
                                          "4"], 4)]


def _par_epoch(torch, trainer, fa, world, tally=None):
    """One epoch of the trainer (its `max_steps` steps), each step's loss
    and, read on rank 0 between barriers, the flash kernels' launches per
    rank (the counts are the process's: the step's delta over the world)
    and its wall time. With `tally` (a `_RankTally`) every rank reads its
    own launches of each step."""
    import torch.distributed as tdist

    step = trainer.train_step
    losses, per_step, times = [], [], []

    def barrier():
        if world > 1:
            tdist.barrier()

    def recorded(state, batch):
        barrier()
        before, t0 = dict(fa.LAUNCHES), time.monotonic()
        mine = dict(tally.mine()) if tally is not None else None
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        if tally is not None:
            per_step.append({k: v - mine.get(k, 0)
                             for k, v in tally.mine().items()
                             if v != mine.get(k, 0)})
        barrier()
        if world == 1 or tdist.get_rank() == 0:
            times.append((time.monotonic() - t0) * 1e3)
            if tally is None:
                per_step.append({k: (v - before[k]) / world
                                 for k, v in fa.LAUNCHES.items()
                                 if v != before[k]})
        barrier()
        return state, metrics

    trainer.train_step = recorded
    trainer.train_epoch(0)
    trainer.train_step = step
    return losses, per_step, times


def parallel_phase(torch, fa, ops) -> dict:
    """ROADMAP A8a on one card (the docstring's phase 28): lm_base's
    sharded training legs against the one-rank run, and the sharded
    generate against the one-rank generate."""
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.inference import make_generate_fn
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.parallel.mesh import (
        build_mesh,
        full_parameters,
        shard_state,
    )
    from ddp_practice_tpu_torch.parallel.sharding_rules import (
        param_sharding_rules,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    t_phase = time.monotonic()
    ref = _cli_trainer(PAR_ARGS + ["-b", "4"])
    depth = ref.model.depth
    want_losses, _, ref_ms = _par_epoch(torch, ref, fa, 1)
    want = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    del ref
    # the sequence phase holds its legs to the same run
    report = {"launches": {}, "one_rank": (want_losses, want, depth)}
    torch.cuda.empty_cache()
    log(f"parallel[one rank] lm_base fp32 sgd, seq 2048, global batch 4, "
        f"3 steps: losses {', '.join(f'{x:.6f}' for x in want_losses)}; "
        f"step ms {', '.join(f'{x:.1f}' for x in ref_ms)} [{CARD}]")
    for label, argv, world in PAR_LEGS:
        _reset_launches(fa)

        def rank(r, argv=argv, world=world):
            trainer = _cli_trainer(PAR_ARGS + argv)
            run = _par_epoch(torch, trainer, fa, world)
            return run, full_parameters(trainer.model)

        t0 = time.monotonic()
        res = run_ranks(rank, world, timeout=600)
        wall = time.monotonic() - t0
        (losses, per_step, times), got = res[0]
        for (other, _, _), _ in res[1:]:
            if other != losses:
                raise AssertionError(f"parallel[{label}]: ranks disagree "
                                     f"on the loss: {other} vs {losses}")
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, want_losses))
        worst, worst_name = 0.0, None
        for name, w in want.items():
            excess = float(((got[name] - w).abs() - PAR_RTOL * w.abs())
                           .max())
            if excess > worst:
                worst, worst_name = excess, name
        log(f"parallel[{label}] {world} ranks as threads sharing one card: "
            f"losses {', '.join(f'{x:.6f}' for x in losses)} (worst "
            f"relative difference {loss_err:.2e}, limit {PAR_LOSS_RTOL}); "
            f"parameters' worst |err| - rtol |want| {worst:.2e} (limit "
            f"{PAR_ATOL}{', at ' + worst_name if worst_name else ''}); "
            f"launches per rank per step {per_step}; step ms (ranks "
            f"sharing one card, not a speed) "
            f"{', '.join(f'{x:.1f}' for x in times)}; wall {wall:.1f} s "
            f"[{CARD}]")
        if loss_err > PAR_LOSS_RTOL or worst > PAR_ATOL:
            raise AssertionError(f"parallel[{label}]: off the one-rank run")
        want_step = {"flash_fwd_packed": depth, "flash_bwd_packed": depth}
        if any(s != want_step for s in per_step) or len(per_step) != 3:
            raise AssertionError(f"parallel[{label}]: launches per rank "
                                 f"per step {per_step}, want {want_step}")
        report["launches"][label] = _launches(fa.LAUNCHES)
        del res, got
        torch.cuda.empty_cache()

    prompt = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))

    def lm_base():
        return create_model("lm_base", device="cuda", seed=2,
                            vocab_size=256, max_len=2048)

    one = lm_base()
    expected = make_generate_fn(one, max_new_tokens=PAR_NEW_TOKENS,
                                temperature=0.0)(prompt).cpu()
    del one

    def gen_rank(r):
        model = lm_base()
        shard_state(model, build_mesh(MeshConfig(tensor=2), "cuda"),
                    param_sharding_rules("lm_base"), "lm_base")
        return make_generate_fn(model, max_new_tokens=PAR_NEW_TOKENS,
                                temperature=0.0)(prompt).cpu()

    _reset_launches(ops)
    t0 = time.monotonic()
    tokens = run_ranks(gen_rank, 2, timeout=600)
    wall = time.monotonic() - t0
    gen_launches = _launches(ops.LAUNCHES)
    # two ranks, each a decode step a new token
    per_token = gen_launches["decode_attention"] / (2 * PAR_NEW_TOKENS)
    same = all(torch.equal(t, expected) for t in tokens)
    log(f"parallel[generate, tensor 2] lm_base fp32 greedy, 2 prompts of "
        f"16, {PAR_NEW_TOKENS} new tokens: tokens identical to one rank's "
        f"{same}; kernel A {gen_launches['decode_attention']} launches = "
        f"{per_token:.0f} per token per rank (6 heads a rank, packed); "
        f"wall {wall:.1f} s [{CARD}]")
    if not same or per_token != depth:
        raise AssertionError("parallel[generate]: tokens or launches off")
    report["generate_launches"] = gen_launches
    report["wall_s"] = time.monotonic() - t_phase
    log(f"parallel phase wall {report['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return report


class _RankTally(dict):
    """Stands in for a wrapper module's LAUNCHES while ranks run as
    threads: each count a wrapper writes (its `+= 1` where it launches a
    kernel) is also tallied for the thread that wrote it, a rank of
    run_ranks, so each rank's launches read apart (and exactly: the
    process-wide read-modify-write can lose an update between threads)."""

    def __init__(self, counts):
        super().__init__(counts)
        self.by_thread: dict = {}

    def __setitem__(self, key, value):
        mine = self.by_thread.setdefault(threading.current_thread().name, {})
        mine[key] = mine.get(key, 0) + 1
        super().__setitem__(key, value)

    def mine(self) -> dict:
        return self.by_thread.get(threading.current_thread().name, {})

    def total(self) -> dict:
        out = {k: 0 for k in self}
        for counts in self.by_thread.values():
            for k, v in counts.items():
                out[k] += v
        return out


def _seq_ring_check(torch, run_ranks) -> float:
    """The ring's flash local (E per block, the merge, G+F with the
    merge's lse cotangent) against its plain blockwise local on the card
    at 4 seq ranks, (b, s, h, d) = (2, 2048, 12, 64): the output, the
    merged lse and dq, dk, dv of a loss reading both, element by element
    within the flash rows' limits (FLASH_TOL), in relative error norm
    within FLASH_REL in fp32 and RING_BF16_REL in bf16. Returns the worst
    |err|."""
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.parallel import ring
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, seq_group

    world, (b, s, h, d) = 4, (2, 2048, 12, 64)
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(29)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda")
                   .to(tdt) for _ in range(3))
        w_out = torch.randn((b, s, h, d), generator=g, device="cuda")
        w_lse = torch.randn((b, s, h), generator=g, device="cuda")
        for causal in (False, True):
            def rank(r, local):
                sp = seq_group(build_mesh(MeshConfig(seq=world), "cuda"))
                xs = [sp.chunk(t).detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
                out, lse = local(*xs, sp=sp, causal=causal)
                loss = ((out.float() * sp.chunk(w_out)).sum()
                        + (lse * sp.chunk(w_lse)).sum())
                grads = torch.autograd.grad(loss, xs)
                torch.cuda.synchronize()
                return [out.detach(), lse.detach(), *grads]

            got, want = (
                [torch.cat(parts, 1) for parts in zip(*run_ranks(
                    lambda r, f=f: rank(r, f), world, timeout=300))]
                for f in (ring._ring_flash_local, ring._ring_xla_local))
            what = f"ring {'causal' if causal else 'full'} {dtype}"
            errs = [_flash_err(torch, "ring E/F/G", a, b_, dtype, i > 1,
                               f"{what} {n}", RING_REL[dtype])
                    for i, (n, a, b_) in enumerate(zip(
                        ("out", "lse", "dq", "dk", "dv"), got, want))]
            worst = max([worst] + [e for e, _ in errs])
            log(f"  sequence[ring kernel check] {what}, 4 ranks, b 2 s "
                f"2048 h 12 d 64, flash local vs plain blockwise local: "
                f"max |err| / relative norm " + "  ".join(
                    f"{n} {e:.2e} / {r_:.2e}" for n, (e, r_) in zip(
                        ("out", "lse", "dq", "dk", "dv"), errs)))
            del got, want
    return worst


def _seq_expected(leg: str, rank: int, depth: int) -> dict:
    """E and G+F launches a step on `rank` in a sequence leg: the causal
    ring runs rank + 1 blocks a layer (its earlier blocks full, its own
    causal, the later ones skipped) on the folded row; Ulysses one call
    a layer, packed at 6 heads a rank (seq 2), "heads" (the folded row)
    at 3 (tensor 2 x seq 2)."""
    if "ring" in leg:
        row, n = "folded", depth * (rank + 1)
    else:
        row, n = ("folded" if "tensor" in leg else "packed"), depth
    return {f"flash_fwd_{row}": n, f"flash_bwd_{row}": n}


def seq_phase(torch, fa, par) -> dict:
    """ROADMAP A8b on one card (the docstring's phase 29): lm_base's
    sequence-parallel legs against phase 28's one-rank run, then the
    ring's kernel check. Returns {"launches": the legs' E/F/G launches,
    "wall_s"}."""
    from ddp_practice_tpu_torch.parallel.mesh import full_parameters
    from ddp_practice_tpu_torch.parallel.threads import run_ranks

    t_phase = time.monotonic()
    want_losses, want, depth = par.pop("one_rank")
    counts = fa.LAUNCHES
    tally = fa.LAUNCHES = _RankTally({k: 0 for k in counts})
    try:
        for label, argv, world in SEQ_LEGS:
            def rank(r, argv=argv, world=world):
                trainer = _cli_trainer(PAR_ARGS + argv)
                run = _par_epoch(torch, trainer, fa, world, tally)
                return run, full_parameters(trainer.model)

            t0 = time.monotonic()
            res = run_ranks(rank, world, timeout=600)
            wall = time.monotonic() - t0
            (losses, _, times), got = res[0]
            for (other, _, _), _ in res[1:]:
                if other != losses:
                    raise AssertionError(f"sequence[{label}]: ranks "
                                         f"disagree on the loss: {other} "
                                         f"vs {losses}")
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, want_losses))
            worst, worst_name = 0.0, None
            for name, w in want.items():
                excess = float(((got[name] - w).abs() - PAR_RTOL * w.abs())
                               .max())
                if excess > worst:
                    worst, worst_name = excess, name
            per_rank = [run[1] for run, _ in res]
            log(f"sequence[{label}] {world} ranks as threads sharing one "
                f"card: losses {', '.join(f'{x:.6f}' for x in losses)} "
                f"(worst relative difference {loss_err:.2e}, limit "
                f"{PAR_LOSS_RTOL}); parameters' worst |err| - rtol |want| "
                f"{worst:.2e} (limit {PAR_ATOL}"
                f"{', at ' + worst_name if worst_name else ''}); launches "
                f"a step by rank {[s[0] for s in per_rank]}; step ms "
                f"(ranks sharing one card, not a speed) "
                f"{', '.join(f'{x:.1f}' for x in times)}; wall {wall:.1f} s "
                f"[{CARD}]")
            if loss_err > PAR_LOSS_RTOL or worst > PAR_ATOL:
                raise AssertionError(f"sequence[{label}]: off the one-rank "
                                     "run")
            for r, steps in enumerate(per_rank):
                expect = _seq_expected(label, r, depth)
                if len(steps) != 3 or any(s != expect for s in steps):
                    raise AssertionError(
                        f"sequence[{label}]: rank {r} launched {steps} a "
                        f"step, want {expect}")
            del res, got
            torch.cuda.empty_cache()
        launches = tally.total()
    finally:
        fa.LAUNCHES = counts
    del want
    torch.cuda.empty_cache()
    worst = _seq_ring_check(torch, run_ranks)
    wall = time.monotonic() - t_phase
    log(f"sequence phase: legs' launches (all ranks) {launches}; ring "
        f"kernel check worst |err| {worst:.2e}; wall {wall:.1f} s")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall}


# the expert phase (ROADMAP A8c, A8f): lm_moe_tc in fp32 under PAR_ARGS's
# optimizer (SGD, momentum 0.9, clip 1.0, lr 1e-2), global batch 4, 3
# steps; legs (label, mesh axes, impl, sp_impl, fsdp, ranks)
EXPERT_BATCH, EXPERT_STEPS = 4, 3
EXPERT_LEGS = [
    ("expert 2 einsum", dict(expert=2), "einsum", None, False, 2),
    ("expert 4 einsum", dict(expert=4), "einsum", None, False, 4),
    ("expert 2 sorted", dict(expert=2), "sorted", None, False, 2),
    ("data 2 x expert 2 gather", dict(data=2, expert=2), "gather", None,
     True, 4),
    ("seq 2 ring einsum", dict(seq=2), "einsum", "ring", False, 2),
    ("seq 2 ulysses sorted", dict(seq=2), "sorted", "ulysses", False, 2),
    ("expert 2 x seq 2 ring", dict(seq=2, expert=2), "einsum", "ring",
     False, 4),
]
# a leg's router metrics against the one-rank run's
EXPERT_HEALTH_ATOL = 1e-6


def _expert_rank_model(torch, state, *, impl, **kw):
    """A rank's lm_moe_tc in fp32 (`kw`: seq_axis, sp_impl), built on the
    meta device and filled on the card from `state`, the one seed's
    weights every rank and leg start from (`create_model` draws every
    weight on the CPU: for each of the phase's ranks that would cost more
    than its steps)."""
    from ddp_practice_tpu_torch.models import LMMoE
    from ddp_practice_tpu_torch.ops.moe import moe_layers

    with torch.device("meta"):
        model = LMMoE(vocab_size=state["tok_embed.weight"].shape[0],
                      max_len=MOE_SEQ, attn_impl="flash", **MOE, **kw)
    model = model.to_empty(device="cuda")
    model.load_state_dict(state)
    for layer in moe_layers(model):
        layer.impl = impl
    return model


def _rank_steps(torch, make_model, batches, *, axes, model_name, tallies,
                batch, fsdp=False, health=()):
    """One leg: every rank's model (`make_model(coords)`, a rank's
    coordinates on every axis) laid out by `parallelize` on the mesh
    `axes` (one rank without), a step of `make_lm_train_step` under
    PAR_ARGS's optimizer (SGD, momentum 0.9, clipping 1.0, lr 1e-2) on its
    rows of each global batch of `batch` rows. Returns per rank (losses,
    the `health` metrics a step, its kernels' launches a step read from
    `tallies`, its coordinates, whole parameters)."""
    from ddp_practice_tpu_torch.config import MeshConfig, TrainConfig
    from ddp_practice_tpu_torch.parallel.mesh import (
        batch_shard,
        build_mesh,
        coords,
        full_parameters,
        parallelize,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks
    from ddp_practice_tpu_torch.train.state import TrainState, make_optimizer
    from ddp_practice_tpu_torch.train.steps import make_lm_train_step

    world = math.prod(axes.values()) if axes else 1
    config = TrainConfig(optimizer="sgd", learning_rate=1e-2, momentum=0.9,
                         clip_norm=1.0, model=model_name)

    def mine():
        return {k: v for t in tallies for k, v in t.mine().items()}

    def rank(r):
        mesh = build_mesh(MeshConfig(**axes), "cuda") if world > 1 else None
        where = coords(mesh)
        model = make_model(where)
        forward, after = parallelize(model, mesh, model_name=model_name,
                                     fsdp=fsdp)
        train = TrainState(0, model, make_optimizer(config, model))
        step = make_lm_train_step(model, seed=config.seed, forward=forward,
                                  after_backward=after)
        rows = batch_shard(mesh).local_slice(batch)
        losses, metrics_rows, per_step = [], [], []
        for tokens in batches:
            before = mine()
            train, metrics = step(train, {"tokens": tokens[rows]})
            losses.append(float(metrics["loss"]))
            metrics_rows.append({k: float(metrics[k]) for k in health})
            torch.cuda.synchronize()
            per_step.append({k: v - before.get(k, 0)
                             for k, v in mine().items()
                             if v != before.get(k, 0)})
        params = (full_parameters(model) if world > 1 else
                  {n: p.detach().clone()
                   for n, p in model.named_parameters()})
        return losses, metrics_rows, per_step, where, params

    return run_ranks(rank, world, timeout=600) if world > 1 else [rank(0)]


def _expert_run(torch, state, batches, *, axes, impl, sp_impl, fsdp,
                tallies):
    """One leg of lm_moe_tc (`_rank_steps`, EXPERT_BATCH rows a global
    batch). Returns per rank (losses, router metrics, its kernels'
    launches a step, its seq coordinate, whole parameters)."""
    kw = {} if sp_impl is None else dict(seq_axis="seq", sp_impl=sp_impl)
    return [(losses, health, steps, where["seq"][0], params)
            for losses, health, steps, where, params in _rank_steps(
                torch, lambda where: _expert_rank_model(
                    torch, state, impl=impl, **kw), batches, axes=axes,
                model_name="lm_moe", tallies=tallies, batch=EXPERT_BATCH,
                fsdp=fsdp, health=MOE_HEALTH)]


def _expert_expected(leg: str, impl: str, seq_rank: int, depth: int,
                     n_moe: int) -> dict:
    """E/F/G and J/K launches a step on a rank: E and G+F a layer on the
    packed row (12 heads, or 6 a rank under Ulysses at seq 2), the causal
    ring's seq_rank + 1 blocks a layer on the folded row; the sorted path
    J twice forward, J transposed twice and K twice backward a routed
    layer, K's second pass after each K (fp32: every unit a slab)."""
    if "ring" in leg:
        row, n = "folded", depth * (seq_rank + 1)
    else:
        row, n = "packed", depth
    want = {f"flash_fwd_{row}": n, f"flash_bwd_{row}": n}
    if impl == "sorted":
        want.update({k: 2 * n_moe for k in ("gmm", "gmm_trhs", "tgmm",
                                            "tgmm_reduce")})
    return want


def expert_phase(torch, fa, gm, ops) -> dict:
    """ROADMAP A8c and A8f on one card (the docstring's phase 30):
    lm_moe_tc's expert- and seq-sharded legs against the one-rank runs,
    the expert-sharded generate against one rank's, and `--expert 2`
    through the CLI. Returns {"launches": the legs' E/F/G and J/K
    launches, "wall_s"}."""
    import copy

    import numpy as np

    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.config import MeshConfig
    from ddp_practice_tpu_torch.inference import make_generate_fn
    from ddp_practice_tpu_torch.parallel.mesh import build_mesh, shard_state
    from ddp_practice_tpu_torch.parallel.sharding_rules import (
        param_sharding_rules,
    )
    from ddp_practice_tpu_torch.parallel.threads import run_ranks
    from ddp_practice_tpu_torch.train.loop import Trainer

    t_phase = time.monotonic()
    vocab, (loader, _) = _moe_loaders(EXPERT_BATCH)
    batches = [torch.from_numpy(np.ascontiguousarray(b["tokens"])).long()
               .cuda() for _, b in zip(range(EXPERT_STEPS), loader)]
    template = _moe_model(torch, impl="einsum", precision="fp32", seed=30,
                          vocab=vocab)
    depth, n_moe = template.depth, template.depth // template.moe_every
    state = {k: v.detach().clone() for k, v in template.state_dict().items()}
    del template
    counts = (fa.LAUNCHES, gm.LAUNCHES)
    fa.LAUNCHES, gm.LAUNCHES = tallies = (
        _RankTally({k: 0 for k in fa.LAUNCHES}),
        _RankTally({k: 0 for k in gm.LAUNCHES}))
    try:
        one = {}
        for impl in ("einsum", "sorted"):
            t0 = time.monotonic()
            losses, health, _, _, params = _expert_run(
                torch, state, batches, axes={}, impl=impl, sp_impl=None,
                fsdp=False, tallies=tallies)[0]
            one[impl] = (losses, health, params)
            log(f"expert[one rank, {impl}] lm_moe_tc fp32 sgd, seq "
                f"{MOE_SEQ}, global batch {EXPERT_BATCH}, {EXPERT_STEPS} "
                f"steps: losses {', '.join(f'{x:.6f}' for x in losses)}; "
                f"last step " + ", ".join(f"{k} {v:.6f}" for k, v in
                                          health[-1].items())
                + f"; wall {time.monotonic() - t0:.1f} s [{CARD}]")
        # legs' launches only: the one-rank runs' stay out of the record
        for t in tallies:
            t.by_thread.clear()
        for label, axes, impl, sp_impl, fsdp, world in EXPERT_LEGS:
            want_losses, want_health, want = one[
                "sorted" if impl == "sorted" else "einsum"]
            t0 = time.monotonic()
            res = _expert_run(torch, state, batches, axes=axes, impl=impl,
                              sp_impl=sp_impl, fsdp=fsdp, tallies=tallies)
            wall = time.monotonic() - t0
            losses, health = res[0][0], res[0][1]
            for other in res[1:]:
                if other[0] != losses:
                    raise AssertionError(f"expert[{label}]: ranks disagree "
                                         f"on the loss: {other[0]} vs "
                                         f"{losses}")
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, want_losses))
            health_err = max(abs(h[k] - w[k]) for r in res
                             for h, w in zip(r[1], want_health)
                             for k in MOE_HEALTH)
            got = res[0][4]
            worst, worst_name = 0.0, None
            for name, w in want.items():
                excess = float(((got[name] - w).abs() - PAR_RTOL * w.abs())
                               .max())
                if excess > worst:
                    worst, worst_name = excess, name
            log(f"expert[{label}] {world} ranks as threads sharing one "
                f"card: losses {', '.join(f'{x:.6f}' for x in losses)} "
                f"(worst relative difference {loss_err:.2e}, limit "
                f"{PAR_LOSS_RTOL}); router metrics' worst difference "
                f"{health_err:.2e} (limit {EXPERT_HEALTH_ATOL}); "
                f"parameters' worst |err| - rtol |want| {worst:.2e} (limit "
                f"{PAR_ATOL}{', at ' + worst_name if worst_name else ''}); "
                f"launches a step by rank {[r[2][0] for r in res]}; wall "
                f"{wall:.1f} s [{CARD}]")
            if (loss_err > PAR_LOSS_RTOL or worst > PAR_ATOL
                    or health_err > EXPERT_HEALTH_ATOL):
                raise AssertionError(f"expert[{label}]: off the one-rank "
                                     "run")
            for r, (_, _, steps, seq_rank, _) in enumerate(res):
                expect = _expert_expected(label, impl, seq_rank, depth,
                                          n_moe)
                if len(steps) != EXPERT_STEPS or any(s != expect
                                                     for s in steps):
                    raise AssertionError(
                        f"expert[{label}]: rank {r} launched {steps} a "
                        f"step, want {expect}")
            del res, got
            torch.cuda.empty_cache()
        launches = {k: v for t in tallies for k, v in t.total().items()}
    finally:
        fa.LAUNCHES, gm.LAUNCHES = counts
    del one

    prompt = torch.randint(0, vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    model = _expert_rank_model(torch, state, impl="einsum")
    expected = make_generate_fn(model, max_new_tokens=PAR_NEW_TOKENS,
                                temperature=0.0)(prompt).cpu()
    del model

    def gen_rank(r):
        model = _expert_rank_model(torch, state, impl="einsum")
        shard_state(model, build_mesh(MeshConfig(expert=2), "cuda"),
                    param_sharding_rules("lm_moe"), "lm_moe")
        return make_generate_fn(model, max_new_tokens=PAR_NEW_TOKENS,
                                temperature=0.0)(prompt).cpu()

    _reset_launches(ops)
    t0 = time.monotonic()
    tokens = run_ranks(gen_rank, 2, timeout=600)
    wall = time.monotonic() - t0
    gen_launches = _launches(ops.LAUNCHES)
    per_token = gen_launches["decode_attention"] / (2 * PAR_NEW_TOKENS)
    same = all(torch.equal(t, expected) for t in tokens)
    log(f"expert[generate, expert 2] lm_moe_tc fp32 greedy, 2 prompts of "
        f"16, {PAR_NEW_TOKENS} new tokens: tokens identical to one rank's "
        f"{same}; kernel A {gen_launches['decode_attention']} launches = "
        f"{per_token:.0f} per token per rank; wall {wall:.1f} s [{CARD}]")
    if not same or per_token != depth:
        raise AssertionError("expert[generate]: tokens or launches off")
    del state
    torch.cuda.empty_cache()

    argv = ["--model", "lm_moe", "--expert", "2", "--precision", "bf16",
            "--seq_len", "512", "-b", "8", "-e", "1", "--max_steps", "5",
            "--optimizer", "adamw", "--lr", "1e-3", "--log_every", "0",
            "--synthetic_size", "200000"]
    t0 = time.monotonic()
    summaries = run_ranks(lambda r: Trainer(config_from_args(
        build_parser().parse_args(argv))).fit(), 2, timeout=600)
    s = summaries[0]
    log(f"expert[cli] {' '.join(argv)}, 2 ranks as threads: "
        f"{s['steps']} steps, eval accuracy {s['accuracy']:.4f} perplexity "
        f"{s['perplexity']:.3f}, " + ", ".join(
            f"{k} {s[k]:.4f}" for k in MOE_HEALTH)
        + f"; wall {time.monotonic() - t0:.1f} s [{CARD}]")
    if s["steps"] != 5 or not math.isfinite(s["perplexity"]):
        raise AssertionError(f"expert[cli]: summary {s}")
    wall = time.monotonic() - t_phase
    log(f"expert phase: legs' launches (all ranks) {launches}; wall "
        f"{wall:.1f} s")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall}


# the pipeline phase (ROADMAP A8d): lm_pipe at lm_base's widths in fp32
# under PAR_ARGS's optimizer, global batch 4, 3 steps; legs (label, mesh
# axes, schedule, microbatches, sp_impl)
PIPE_BATCH, PIPE_STEPS, PIPE_SEQ = 4, 3, 2048
PIPE_MODEL = dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072,
                  max_len=PIPE_SEQ, attn_impl="flash")
PIPE_LEGS = [
    ("pipe 2 gpipe", dict(pipe=2), "gpipe", 2, None),
    ("pipe 4 gpipe", dict(pipe=4), "gpipe", 4, None),
    ("pipe 4 1f1b", dict(pipe=4), "1f1b", 4, None),
    ("pipe 2 interleaved", dict(pipe=2), "interleaved", 2, None),
    ("data 2 x pipe 2 1f1b", dict(data=2, pipe=2), "1f1b", 2, None),
    ("pipe 2 x tensor 2 1f1b", dict(pipe=2, tensor=2), "1f1b", 2, None),
    ("pipe 2 x seq 2 ring gpipe", dict(seq=2, pipe=2), "gpipe", 2, "ring"),
]


def _pipe_expected(schedule, P, M, stage, seq_rank, sp_impl, depth):
    """E and G+F launches a step on a pipe rank, remat on (the registry's):
    with L = depth / P blocks a stage, GPipe runs L a microbatch forward
    and again in the stage's recompute (2 L M), 1F1B runs L in each F
    tick (not on the last stage, whose forward is its B tick), L in each
    B tick and L more in the blocks' remat (3 L M; 2 L M on the last
    stage), interleaved runs every chunk's F tick, B tick and remat (3 L
    M), and every schedule L M backwards. Packed at 12 (or 6 under tensor
    2) heads; the causal ring multiplies each by seq_rank + 1 blocks on
    the folded row."""
    L = depth // P
    fwd = {"gpipe": 2, "interleaved": 3}.get(
        schedule, 2 if stage == P - 1 else 3) * L * M
    bwd = L * M
    row = "packed"
    if sp_impl == "ring":
        row, fwd, bwd = "folded", fwd * (seq_rank + 1), bwd * (seq_rank + 1)
    return {f"flash_fwd_{row}": fwd, f"flash_bwd_{row}": bwd}


def _pipe_run(torch, state, vocab, batches, *, axes, schedule, M, sp_impl,
              tally):
    """One leg of lm_pipe (`_rank_steps`, PIPE_BATCH rows a global batch),
    each rank's model built on the meta device and filled from `state`,
    the one seed's weights. Returns per rank (losses, launches a step,
    pipe and seq coordinates, whole parameters)."""
    from ddp_practice_tpu_torch.models import PipelinedLM

    kw = {} if sp_impl is None else dict(seq_axis="seq", sp_impl=sp_impl)

    def make_model(where):
        with torch.device("meta"):
            model = PipelinedLM(vocab_size=vocab,
                                num_stages=where["pipe"][1],
                                num_microbatches=M, schedule=schedule,
                                **PIPE_MODEL, **kw)
        model = model.to_empty(device="cuda")
        model.load_state_dict(state)
        return model

    return [(losses, steps, where["pipe"][0], where["seq"][0], params)
            for losses, _, steps, where, params in _rank_steps(
                torch, make_model, batches, axes=axes, model_name="lm_pipe",
                tallies=(tally,), batch=PIPE_BATCH)]


def pipe_phase(torch, fa) -> dict:
    """ROADMAP A8d on one card (the docstring's phase 31): lm_pipe's
    pipelined legs against its one-rank run and `--pipe 2 --pipe_schedule
    1f1b` through the CLI. Returns {"launches": the legs' E/F/G launches,
    "wall_s"}."""
    import numpy as np

    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.parallel.threads import run_ranks
    from ddp_practice_tpu_torch.train.loop import Trainer

    t_phase = time.monotonic()
    vocab, (loader, _) = _moe_loaders(PIPE_BATCH, PIPE_SEQ)
    batches = [torch.from_numpy(np.ascontiguousarray(b["tokens"])).long()
               .cuda() for _, b in zip(range(PIPE_STEPS), loader)]
    template = create_model("lm_pipe", device="cuda", seed=31,
                            vocab_size=vocab, **PIPE_MODEL)
    depth = template.depth
    state = {k: v.detach().clone() for k, v in template.state_dict().items()}
    del template
    counts = fa.LAUNCHES
    tally = fa.LAUNCHES = _RankTally({k: 0 for k in counts})
    try:
        t0 = time.monotonic()
        want_losses, _, _, _, want = _pipe_run(
            torch, state, vocab, batches, axes={}, schedule="gpipe", M=1,
            sp_impl=None, tally=tally)[0]
        log(f"pipe[one rank] lm_pipe num_stages 1 (lm_base widths, depth "
            f"{depth}, remat), fp32 sgd, seq {PIPE_SEQ}, global batch "
            f"{PIPE_BATCH}, {PIPE_STEPS} steps: losses "
            f"{', '.join(f'{x:.6f}' for x in want_losses)}; wall "
            f"{time.monotonic() - t0:.1f} s [{CARD}]")
        tally.by_thread.clear()   # the legs' launches only
        for label, axes, schedule, M, sp_impl in PIPE_LEGS:
            t0 = time.monotonic()
            res = _pipe_run(torch, state, vocab, batches, axes=axes,
                            schedule=schedule, M=M, sp_impl=sp_impl,
                            tally=tally)
            wall = time.monotonic() - t0
            losses = res[0][0]
            for other in res[1:]:
                if other[0] != losses:
                    raise AssertionError(f"pipe[{label}]: ranks disagree "
                                         f"on the loss: {other[0]} vs "
                                         f"{losses}")
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, want_losses))
            got = res[0][4]
            worst, worst_name = 0.0, None
            for name, w in want.items():
                excess = float(((got[name] - w).abs() - PAR_RTOL * w.abs())
                               .max())
                if excess > worst:
                    worst, worst_name = excess, name
            P = axes["pipe"]
            expect = [_pipe_expected(schedule, P, M, stage, seq_rank,
                                     sp_impl, depth)
                      for _, _, stage, seq_rank, _ in res]
            log(f"pipe[{label}] {schedule}, M {M}, {len(res)} ranks as "
                f"threads sharing one card: losses "
                f"{', '.join(f'{x:.6f}' for x in losses)} (worst relative "
                f"difference {loss_err:.2e}, limit {PAR_LOSS_RTOL}); "
                f"parameters' worst |err| - rtol |want| {worst:.2e} (limit "
                f"{PAR_ATOL}{', at ' + worst_name if worst_name else ''}); "
                f"launches a step by rank {[r[1][0] for r in res]} "
                f"(formula {expect}); wall {wall:.1f} s [{CARD}]")
            if loss_err > PAR_LOSS_RTOL or worst > PAR_ATOL:
                raise AssertionError(f"pipe[{label}]: off the one-rank run")
            for r, ((_, steps, _, _, _), want_r) in enumerate(
                    zip(res, expect)):
                if len(steps) != PIPE_STEPS or any(s != want_r
                                                   for s in steps):
                    raise AssertionError(
                        f"pipe[{label}]: rank {r} launched {steps} a step, "
                        f"want {want_r}")
            del res, got
            torch.cuda.empty_cache()
        launches = tally.total()
    finally:
        fa.LAUNCHES = counts
    del want, state
    torch.cuda.empty_cache()

    argv = ["--model", "lm_pipe", "--pipe", "2", "--pipe_schedule", "1f1b",
            "--microbatches", "2", "--attn_impl", "flash", "--num_heads",
            "4", "--precision", "bf16", "--seq_len", "512", "-b", "8", "-e",
            "1", "--max_steps", "5", "--optimizer", "adamw", "--lr", "1e-3",
            "--log_every", "0", "--synthetic_size", "200000"]
    t0 = time.monotonic()
    summaries = run_ranks(lambda r: Trainer(config_from_args(
        build_parser().parse_args(argv))).fit(), 2, timeout=600)
    s = summaries[0]
    log(f"pipe[cli] {' '.join(argv)}, 2 ranks as threads: {s['steps']} "
        f"steps, eval accuracy {s['accuracy']:.4f} perplexity "
        f"{s['perplexity']:.3f}; wall {time.monotonic() - t0:.1f} s "
        f"[{CARD}]")
    if s["steps"] != 5 or not math.isfinite(s["perplexity"]):
        raise AssertionError(f"pipe[cli]: summary {s}")
    torch.cuda.empty_cache()

    wall = time.monotonic() - t_phase
    log(f"pipe phase: legs' launches (all ranks) {launches}; wall "
        f"{wall:.1f} s")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall}


def _cli_trainer(argv):
    """A Trainer from the CLI's parser and config, as `cli.main` builds it."""
    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train.loop import Trainer

    return Trainer(config_from_args(build_parser().parse_args(argv)))


def convnet_train_phase(torch, extra, *, label, gate_accuracy=0.5):
    """`fit` through the CLI's parser and config with the reference's
    defaults (convnet, mnist, 3 epochs, batch 32, SGD lr 1e-4, fp32) plus
    `extra`, evaluating after every epoch. With no placement flag the
    corpus is device-resident ("auto") and each step a CUDA-graph replay;
    `--data_placement host` streams host batches through eager steps.
    Each step's loss stays on the device and a CUDA event marks its end.
    Reports images/s per card and the median step (steps after an epoch's
    eval pass left out), MFU against the dense bf16 peak, the accuracy
    after each epoch and the first epoch at 91% (reported, not gated: the
    synthetic set is not MNIST). Checks that the loss fell (mean of the
    last 50 steps against the first 50) and that the last accuracy is
    `gate_accuracy` or more (chance is 0.1)."""
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        train_flops_per_image,
    )

    trainer = _cli_trainer(CONVNET_ARGS + ["--eval_every", "1"] + extra)
    config = trainer.config
    accuracy = []
    losses, ends, k, graph, unwrap = _record_calls(torch, trainer)
    evaluate = trainer.evaluate

    def recorded_eval():
        accuracy.append(evaluate())
        return accuracy[-1]

    trainer.evaluate = recorded_eval
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unwrap()
    trainer.evaluate = evaluate
    loss = [float(x) for x in losses]
    n = len(trainer.train_loader)
    if config.max_steps_per_epoch:
        n = min(n, config.max_steps_per_epoch)
    calls = -(-n // k)   # calls an epoch
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i]) / k
                                for i in range(1, len(ends)) if i % calls)
    ds = trainer.train_ds
    flops = train_flops_per_image("convnet", ds.image_shape,
                                  ds.num_classes) * trainer.global_batch
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    reached = next((i + 1 for i, a in enumerate(accuracy) if a >= 0.91),
                   None)
    report = {
        "loss": loss, "step_ms": step_ms, "steps_per_call": k,
        "images_per_s": trainer.global_batch / (step_ms / 1e3),
        "mfu": flops / (step_ms / 1e3) / peak if peak else None,
        "accuracy": accuracy, "epochs_to_91": reached, "wall_s": wall,
        "fit_images_per_s": summary["images_per_sec_per_chip"],
    }
    w = min(50, len(loss) // 4)
    head, tail = statistics.fmean(loss[:w]), statistics.fmean(loss[-w:])
    mfu = "not measured" if peak is None else f"{report['mfu']:.6f}"
    log(f"convnet train[{label}] {config.model} {config.precision} "
        f"{config.optimizer} lr {config.learning_rate}, {ds.name} "
        f"{len(ds)} images {ds.image_shape}, batch {trainer.global_batch}, "
        f"{config.epochs} epochs x {n} steps ({_placement(trainer, graph)}"
        f"), wall {wall:.1f} s: loss mean of the first {w} calls "
        f"{head:.4f}, of the last {w} {tail:.4f}")
    log(f"  median step {step_ms:.3f} ms (CUDA events between call ends), "
        f"{report['images_per_s']:.0f} images/s per card, MFU {mfu} "
        f"against {(peak or 0) / 1e12:.1f} TFLOP/s ({flops / 1e9:.3f} "
        f"GFLOP/step analytic); fit's own "
        f"{report['fit_images_per_s']:.0f} images/s over its train "
        f"seconds; test accuracy after each epoch "
        + ", ".join(f"{a:.4f}" for a in accuracy)
        + "; epochs to 91%: "
        + (str(reached) if reached else
           f"not reached (last {accuracy[-1]:.4f})") + f" [{CARD}]")
    if not tail < head:
        raise AssertionError(f"convnet train[{label}]: loss did not fall "
                             f"({head:.4f} -> {tail:.4f})")
    if not accuracy[-1] >= gate_accuracy:
        raise AssertionError(f"convnet train[{label}]: accuracy "
                             f"{accuracy[-1]:.4f} < {gate_accuracy}")
    return trainer, report


_CONV_KINDS = (("conv (cuDNN)", "conv|fprop|dgrad|wgrad|cudnn|implicit|"
                                "winograd|fft"),
               ("matmul", "gemm|gemv|nvjet|cutlass"),
               ("pool", "pool"),
               ("reduce", "reduce"),
               ("elementwise", "elementwise|vectorized|unrolled"))


def _image_profile_log(prof, steps, host_ms, trainer, label, how):
    """Log an image model's profile (the ConvNet's or a ResNet's, named
    by the trainer's config) of `steps` steps against their host wall:
    device busy a step, the device's idle share, device ops a step and
    device time by kind (cuDNN convolutions, cuBLAS matmul, pooling,
    reductions, elementwise, other)."""
    import re

    model = trainer.config.model
    summary = _profile_summary(prof)
    if summary is None:
        log(f"{model} profile[{label}]: torch.profiler recorded no device "
            f"events; device time not measured (host wall {host_ms:.3f} "
            f"ms/step) [{CARD}]")
        return
    kinds = dict.fromkeys([k for k, _ in _CONV_KINDS] + ["other"], 0.0)
    for (_, name), ps in summary["ops"].items():
        low = name.lower()
        kind = next((k for k, rx in _CONV_KINDS if re.search(rx, low)),
                    "other")
        kinds[kind] += ps / 1e9 / steps
    device_ms = sum(kinds.values())
    log(f"{model} profile[{label}] (batch {trainer.global_batch}{how}): "
        f"host wall {host_ms:.3f} ms/step, device busy {device_ms:.3f} "
        f"ms/step, device idle share "
        f"{max(0.0, 1 - device_ms / host_ms):.3f}, "
        f"{_device_ops(summary) // steps} device ops/step; device time by "
        f"kind " + ", ".join(f"{k} {v / device_ms:.3f}"
                             for k, v in kinds.items()) + f" [{CARD}]")
    _log_top_ops(summary, steps, 8, "us", 100)


def image_profile(torch, trainer, label):
    """One eager train step of an image model (ConvNet or ResNet) on a
    host batch under torch.profiler, after warm steps, against the host
    wall of 20 (ends in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._to_device(next(iter(trainer.train_loader)))
    for _ in range(3):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    _image_profile_log(prof, 1, host_ms, trainer, label, "")


def image_profile_resident(torch, trainer, label, n=200, m=20):
    """A resident image model's steps (ConvNet or ResNet) as its epoch
    runs them (one step a call, each a replay of the captured step) over
    rows of the epoch's grid: the host wall of `n` calls (ends in a
    synchronize), then `m` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    idx, _ = trainer.train_loader.epoch_plan()
    grid = torch.from_numpy(idx[:3 + n + m]).cuda()
    step, data = trainer.resident_train_step, trainer._train_data
    for i in range(3):
        trainer.state, _ = step(trainer.state, data, grid[i:i + 1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 3 + n):
        trainer.state, _ = step(trainer.state, data, grid[i:i + 1])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3 + n, 3 + n + m):
            trainer.state, _ = step(trainer.state, data, grid[i:i + 1])
        torch.cuda.synchronize()
    _image_profile_log(prof, m, host_ms, trainer, label,
                       ", one graph replay a step")


def resnet_train_phase(torch, argv, *, label):
    """`fit` of a ResNet through the CLI's parser and config (`argv`:
    RESNET18_ARGS or RESNET50_ARGS plus the leg's flags), each call's
    loss kept on the device and its end marked with a CUDA event, then
    the eval pass. Reports the loss at steps 1, 10, 20 and 30 (the last
    below the first), the median step, images/s per card, MFU against
    the dense bf16 peak, the eval accuracy and peak device memory."""
    from ddp_practice_tpu_torch.utils.flops import (
        chip_peak_flops,
        train_flops_per_image,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _cli_trainer(argv)
    config, ds = trainer.config, trainer.train_ds
    accuracy = []
    losses, ends, k, graph, unwrap = _record_calls(torch, trainer)
    evaluate = trainer.evaluate

    def recorded_eval():
        accuracy.append(evaluate())
        return accuracy[-1]

    trainer.evaluate = recorded_eval
    t0 = time.monotonic()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    unwrap()
    trainer.evaluate = evaluate
    loss = [float(x) for x in losses]
    step_ms = statistics.median(ends[i - 1].elapsed_time(ends[i]) / k
                                for i in range(1, len(ends)))
    flops = train_flops_per_image(config.model, ds.image_shape,
                                  trainer.model.num_classes) \
        * trainer.global_batch
    peak = chip_peak_flops(torch.cuda.get_device_name(0))
    report = {"loss": loss, "step_ms": step_ms,
              "images_per_s": trainer.global_batch / (step_ms / 1e3),
              "mfu": flops / (step_ms / 1e3) / peak if peak else None,
              "accuracy": accuracy[-1], "wall_s": wall,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    at = [s for s in (1, 10, 20, 30) if s <= len(loss)]
    mfu = "not measured" if peak is None else f"{report['mfu']:.6f}"
    log(f"{config.model} train[{label}] {config.precision} "
        f"{config.optimizer} lr {config.learning_rate}, augment "
        f"{config.augment_kind if config.augment else 'off'}, {ds.name} "
        f"{len(ds)} images {ds.image_shape}, batch {trainer.global_batch}, "
        f"{len(loss)} steps ({_placement(trainer, graph)}; loader "
        f"{type(trainer.train_loader._gather).__name__}), wall {wall:.1f} "
        f"s: loss at steps " + ", ".join(
            f"{s} {loss[s - 1]:.4f}" for s in at) + f" [{CARD}]")
    log(f"  median step {step_ms:.3f} ms (CUDA events between call ends), "
        f"{report['images_per_s']:.0f} images/s per card, MFU {mfu} "
        f"against {(peak or 0) / 1e12:.1f} TFLOP/s ({flops / 1e9:.1f} "
        f"GFLOP/step analytic), eval accuracy {report['accuracy']:.4f}, "
        f"peak memory {report['peak_gib']:.2f} GiB [{CARD}]")
    if not all(math.isfinite(x) for x in loss) or not loss[-1] < loss[0]:
        raise AssertionError(f"{config.model} train[{label}]: loss did not "
                             f"fall ({loss[0]:.4f} -> {loss[-1]:.4f})")
    return trainer, report


def resnet18_legs(torch):
    """ResNet-18 on synthetic CIFAR-10 (BASELINE config 3, bench.py:78-81:
    batch 512, bf16, `--augment` crop_flip): the "auto" leg (the 184 MB
    corpus resident, each step a graph replay) and the host leg (eager
    steps over host batches) over the same 30 steps; their per-step
    losses agree at MODEL_BF16_LOSS relative. Returns the resident
    trainer (profiled later) and its report."""
    res, rep = resnet_train_phase(torch, RESNET18_ARGS,
                                  label="config 3, auto = resident")
    if res.resident_train_step is None:
        raise AssertionError("resnet18: the 'auto' leg did not go resident")
    host, host_rep = resnet_train_phase(
        torch, RESNET18_ARGS + ["--data_placement", "host"],
        label="config 3, host")
    del host
    held, worst, exact = _agree("resnet18", host_rep["loss"], rep["loss"],
                                1, MODEL_BF16_LOSS)
    log(f"resnet18 resident vs host (bf16, batch 512, crop_flip): {held} "
        f"steps' losses agree, worst relative difference {worst:.2e} "
        f"({'bit-identical' if exact else 'not bit-identical'}); median "
        f"step resident {rep['step_ms']:.3f} ms, host "
        f"{host_rep['step_ms']:.3f} ms; {rep['images_per_s']:.0f} vs "
        f"{host_rep['images_per_s']:.0f} images/s [{CARD}]")
    return res, rep


def resnet50_leg(torch, data_dir):
    """ResNet-50 (BASELINE config 5, bench.py:82-85: 224x224x3, 1000
    classes, batch 128, bf16, `--augment_kind rrc`, `--loader native`) on
    the synthetic ImageNet corpus, cut to RESNET50_CORPUS images and
    written under `data_dir` as a real corpus's `imagenet-arrays`
    (the caller deletes it). Times the write, then the native and the
    numpy gather of 128-image batches from the memory-mapped corpus
    (bit-equal), then 20 steps on the host path and the eval pass. The
    loader is named: a native gather that fails to build fails the leg.
    Returns the trainer (profiled later) and its report."""
    import numpy as np

    from ddp_practice_tpu_torch.data import datasets, native_loader

    n_train, n_test = RESNET50_CORPUS
    root = f"{data_dir}/imagenet-arrays"
    t0 = time.monotonic()
    train = datasets.synthetic_imagenet_corpus(root, "train", n=n_train)
    datasets.synthetic_imagenet_corpus(root, "test", n=n_test)
    write_s = time.monotonic() - t0
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
    gather = native_loader.NativeGather(native_loader.require(), train)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, n_train, 128) for _ in range(20)]

    def timed(fn):
        fn(batches[0])
        t = time.perf_counter()
        out = [fn(i) for i in batches]
        return (time.perf_counter() - t) * 1e3 / len(batches), out

    plain_ms, plain = timed(lambda i: (train.images[i], train.labels[i]))
    native_ms, native = timed(gather)
    for (a, la), (b, lb) in zip(native, plain):
        if not (np.array_equal(a, b) and np.array_equal(la, lb)):
            raise AssertionError("native gather differs from numpy's")
    log(f"resnet50 corpus: {n_train} + {n_test} images 224x224x3 written "
        f"in {write_s:.1f} s ({nbytes / 1e6:.0f} MB on disk); gather of a "
        f"128-image batch from the memory-mapped corpus: native "
        f"{native_ms:.3f} ms, numpy {plain_ms:.3f} ms (bit-equal, 20 "
        f"batches, page cache warm)")
    trainer, report = resnet_train_phase(
        torch, RESNET50_ARGS + ["--data_dir", data_dir],
        label="config 5, corpus cut to 4096/1024")
    if trainer.resident_train_step is not None or type(
            trainer.train_loader._gather) is not native_loader.NativeGather:
        raise AssertionError("resnet50: not on the host path through the "
                             "native gather")
    report.update(write_s=write_s, native_ms=native_ms, plain_ms=plain_ms)
    return trainer, report


def resnet50_step_check(torch):
    """ResNet-50 (224x224x3, 1000 classes, batch RESNET50_CHECK_BATCH)
    on the card against the host CPU, from one seeded state and batch.
    First rrc: `apply_augment` of the same fp32 images under the same key
    on the card and on the host, at RESNET50_RRC_TOL. Then one train step
    through `make_train_step` (SGD) on the host's augmented images, in
    float64 and in fp32 on the card (TF32 off) and in fp32 on the host,
    each against float64 on the host at RESNET50_STEP_TOL: the loss, the
    logits, every updated running statistic and the grads. Each block's
    last BatchNorm scale (zero at init) is drawn in [0.05, 0.15), as
    early training has it, the other scales in [0.75, 1.25) and every
    bias in [-0.1, 0.1), so every weight has a gradient."""
    import numpy as np

    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.augment import apply_augment, augment_rng
    from ddp_practice_tpu_torch.ops.batchnorm import BatchNorm
    from ddp_practice_tpu_torch.train.state import TrainState
    from ddp_practice_tpu_torch.train.steps import (
        make_train_step,
        prepare_image,
    )

    t0 = time.monotonic()
    b, shape = RESNET50_CHECK_BATCH, (224, 224, 3)
    rng = np.random.default_rng(15)
    images = prepare_image(torch.from_numpy(
        rng.integers(0, 256, (b, *shape), np.uint8)))
    labels = torch.from_numpy(rng.integers(0, 1000, b))
    key = augment_rng(0, 0)
    aug = apply_augment(images, key, "rrc")
    rrc_err = float((apply_augment(images.cuda(), key, "rrc").cpu()
                     - aug).abs().max())
    kw = dict(num_classes=1000, image_shape=shape)
    base = create_model("resnet50", device="cpu", seed=15, **kw)
    g = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for m in base.modules():
            if isinstance(m, BatchNorm):
                lo, hi = (0.05, 0.15) if m.zero_scale else (0.75, 1.25)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g)
                               * (hi - lo) + lo)
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) * 0.2
                             - 0.1)
    sides = {}
    for side, device, dtype in (("host float64", "cpu", torch.float64),
                                ("card float64", "cuda", torch.float64),
                                ("card fp32", "cuda", torch.float32),
                                ("host fp32", "cpu", torch.float32)):
        model = create_model("resnet50", device=device, seed=15,
                             policy=PrecisionPolicy(dtype, dtype), **kw)
        model.load_state_dict(base.state_dict())
        state = TrainState(step=0, model=model, optimizer=torch.optim.SGD(
            model.parameters(), lr=0.05, momentum=0.9))
        seen = []
        hook = model.register_forward_hook(
            lambda _m, _a, out: seen.append(out.detach()))
        _, metrics = make_train_step(model)(state, {
            "image": aug.to(device, dtype), "label": labels.to(device)})
        hook.remove()
        sides[side] = dict(
            loss=float(metrics["loss"]), logits=seen[0].double().cpu(),
            stats={n: v.double().cpu() for n, v in model.named_buffers()
                   if n.endswith(("running_mean", "running_var"))},
            grads={n: p.grad.double().cpu()
                   for n, p in model.named_parameters()})
        del model, state
    want = sides.pop("host float64")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def cat(grads):
        return torch.cat([v.flatten() for v in grads.values()])

    log(f"resnet50 check (224, 1000 classes, batch {b}): rrc on the card "
        f"vs the host, worst difference {rrc_err:.2e}; one train step "
        f"against float64 on the host (loss {want['loss']:.6f}), relative "
        f"error norms:")
    over = {} if rrc_err <= RESNET50_RRC_TOL else {"rrc": rrc_err}
    for side, got in sides.items():
        per = {n: rel(v, want["grads"][n]) for n, v in got["grads"].items()}
        leaf = max(per, key=per.get)
        err = dict(
            loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            logits=rel(got["logits"], want["logits"]),
            stats=max(rel(v, want["stats"][n])
                      for n, v in got["stats"].items()),
            grads=rel(cat(got["grads"]), cat(want["grads"])),
            grads_leaf=per[leaf])
        log(f"  {side}: loss {err['loss']:.2e}, logits {err['logits']:.2e}"
            f", running statistics {err['stats']:.2e}, all grads "
            f"{err['grads']:.2e}, each leaf median "
            f"{statistics.median(per.values()):.2e}, worst "
            f"{err['grads_leaf']:.2e} ({leaf}) of {len(per)}")
        tol = RESNET50_STEP_TOL[side.split()[1]]
        over.update({f"{side} {k}": v for k, v in err.items()
                     if not v <= tol[k]})
    log(f"resnet50 check: {time.monotonic() - t0:.1f} s [{CARD}]")
    if over:
        raise AssertionError(f"resnet50 check: {over} over "
                             f"{RESNET50_RRC_TOL} (rrc) and "
                             f"{RESNET50_STEP_TOL}")


def _leaves(state) -> dict:
    from ddp_practice_tpu_torch import checkpoint as ckpt

    return {k: v.detach().float().cpu()
            for k, v in ckpt.state_leaves(state).items()}


def convnet_resume_leg(torch):
    """Save -> corrupt the newest manifest -> resume, against an
    uninterrupted run, on the card: the ConvNet (SGD, momentum 0.9, lr
    0.01) on 3200 synthetic images, 100 steps an epoch. Uninterrupted: 3
    epochs. Interrupted: 2 epochs with a checkpoint after each, the newest
    manifest truncated, then a resumed 3-epoch run, which must fall back
    to the epoch-1 checkpoint. cuDNN is set deterministic for this leg (it
    picks conv algorithms that may reduce in another order from run to
    run); the two runs' final states must agree at 1e-5 relative (+1e-6),
    parameters, buffers and optimizer state, and the leg says whether
    they are bit-identical."""
    import shutil

    from ddp_practice_tpu_torch import checkpoint as ckpt

    base = CONVNET_ARGS + ["--synthetic_size", "3200", "--momentum", "0.9",
                           "--lr", "0.01"]
    d = "build/smoke_ckpt/convnet"
    shutil.rmtree(d, ignore_errors=True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.monotonic()
        whole = _cli_trainer(base)
        whole.fit()
        first = _cli_trainer(base + ["-e", "2", "--ckpt_dir", d])
        first.config = first.config.replace(checkpoint_every_epochs=1)
        first.fit()
        steps = ckpt.all_steps(d)
        man = f"{d}/step_{steps[-1]}/manifest.json"
        with open(man, "rb") as f:
            torn = f.read()[:40]
        with open(man, "wb") as f:
            f.write(torn)
        t1 = time.monotonic()
        resumed = _cli_trainer(base + ["--ckpt_dir", d, "--resume"])
        restore_s = time.monotonic() - t1
        back_to = resumed.state.step
        resumed.fit()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        torch.backends.cudnn.deterministic = was
    want, got = _leaves(whole.state), _leaves(resumed.state)
    if list(want) != list(got) or whole.state.step != resumed.state.step:
        raise AssertionError(f"convnet resume: leaves or steps differ "
                             f"({whole.state.step} vs {resumed.state.step})")
    worst, exact = 0.0, True
    for name, w in want.items():
        err = (got[name] - w).abs()
        exact &= bool(torch.equal(got[name], w))
        if (err > 1e-6 + 1e-5 * w.abs()).any():
            raise AssertionError(f"convnet resume: {name} differs from the "
                                 f"uninterrupted run by {err.max():.3e}")
        worst = max(worst, float(err.max()))
    if back_to != steps[0] or steps != [100, 200]:
        raise AssertionError(f"convnet resume: checkpoints {steps}, resumed "
                             f"at step {back_to} (want 100, past the torn "
                             f"step_200)")
    log(f"convnet resume (cudnn deterministic): checkpoints at steps "
        f"{steps}, step_{steps[-1]}'s manifest truncated, resumed at step "
        f"{back_to} (restore {restore_s * 1e3:.1f} ms incl. building the "
        f"trainer), final step {resumed.state.step}: "
        f"{len(want)} leaves {'bit-identical' if exact else 'agree'} with "
        f"the uninterrupted run (max abs diff {worst:.3e}); wall "
        f"{wall:.1f} s")


def _tokens_text(tokens) -> str:
    return bytes(int(t) % 256 for t in tokens).decode("utf-8",
                                                      errors="replace")


def checkpoint_timing(torch, trainer):
    """Wall time on the card of the checkpoint paths over the lm_base
    train state (params, buffers, AdamW moments): save, save_async's
    return (the copy to host) and its wait, restore."""
    import shutil

    from ddp_practice_tpu_torch import checkpoint as ckpt

    d = "build/smoke_ckpt/timing"
    shutil.rmtree(d, ignore_errors=True)
    leaves = ckpt.state_leaves(trainer.state)
    nbytes = sum(t.numel() * 4 for t in leaves.values())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ckpt.save(d, trainer.state, step=1)
    t1 = time.monotonic()
    handle = ckpt.save_async(d, trainer.state, step=2)
    t2 = time.monotonic()
    handle.wait()
    t3 = time.monotonic()
    ckpt.restore(d, trainer.state)
    torch.cuda.synchronize()
    t4 = time.monotonic()
    log(f"checkpoint timing (lm_base bf16 train state, {len(leaves)} "
        f"leaves, {nbytes / 2**20:.0f} MiB as fp32): save {t1 - t0:.3f} s, "
        f"save_async returns after {t2 - t1:.3f} s (host copies) and "
        f"publishes after {t3 - t1:.3f} s, restore {t4 - t3:.3f} s")
    shutil.rmtree(d, ignore_errors=True)


def generate_serve_leg(torch, ops):
    """lm_base (RoPE, bf16, flash, AdamW) trains 6 steps on the bytes of
    the repo's CUDA sources (`--dataset text`, vocabulary 256, so text
    prompts are in range) with a checkpoint every 3 steps (asynchronous)
    and one at the end; then from that checkpoint, through the entry
    points a user calls:
    - generate.py greedy (bf16 policy, bf16 parameters streamed): kernel
      A's launches equal depth x the decode steps, then with `--kv_cache
      int8` kernel B's; nothing else launches;
    - at fp32 (load_lm(precision="fp32")), kernel and plain decode
      (set_decode_impl) give identical greedy tokens, policy cache and
      int8 cache;
    - serve/bench.py `--ckpt_dir` serves 4 prompts through the slot
      engine and every request completes; kernel A launched.
    Returns the launches of each generate run."""
    import contextlib
    import io
    import shutil

    import ddp_practice_tpu_torch.generate as generate
    from ddp_practice_tpu_torch import checkpoint as ckpt
    from ddp_practice_tpu_torch.inference import encode_bytes, make_generate_fn
    from ddp_practice_tpu_torch.serve import bench

    d = "build/smoke_ckpt/lm_base"
    shutil.rmtree(d, ignore_errors=True)
    argv = TRAIN_ARGS + ["--pos_emb", "rope", "--max_steps", "6",
                         "--ckpt_dir", d, "--ckpt_every", "3",
                         "--dataset", "text", "--data_dir",
                         "ddp_practice_tpu_torch/csrc"]
    trainer = _cli_trainer(argv)
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    steps = ckpt.all_steps(d)
    log(f"generate leg: lm_base rope bf16 trained {summary['steps']} steps "
        f"with checkpoints at {steps} in {time.monotonic() - t0:.1f} s "
        f"(eval accuracy {summary['accuracy']:.4f})")
    if steps != [3, 6]:
        raise AssertionError(f"generate leg: checkpoints {steps}")
    checkpoint_timing(torch, trainer)
    depth = trainer.model.depth
    del trainer
    torch.cuda.empty_cache()

    prompt, new = "__global__ void", 48
    launches = {}
    for cache, kernel in (("policy", "decode_attention"),
                          ("int8", "decode_attention_int8")):
        ops.reset_launches()
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            generate.main(["--ckpt_dir", d, "--prompt", prompt,
                           "--max_new_tokens", str(new), "--temperature",
                           "0", "--kv_cache", cache])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        launches[kernel] = ops.LAUNCHES[kernel]
        if got != {kernel: depth * new}:
            raise AssertionError(f"generate[{cache}]: launches {got}, want "
                                 f"{{{kernel!r}: {depth} x {new}}}")
        log(f"generate[{cache} cache] (bf16 params streamed): {new} greedy "
            f"tokens in {wall:.2f} s incl. the checkpoint load, launches "
            f"{got} = depth {depth} x {new} decode steps; text "
            f"{out.getvalue().strip()[:60]!r}")
        torch.cuda.empty_cache()

    ids = torch.from_numpy(encode_bytes(prompt)).long()
    for cache in ("policy", "int8"):
        model, _ = generate.load_lm(d, kv_cache=cache, precision="fp32")
        runs = {}
        for impl in ("kernel", "plain"):
            model.set_decode_impl(impl)
            gen = make_generate_fn(model, max_new_tokens=new,
                                   temperature=0.0)
            runs[impl] = gen(ids)[0].tolist()
        model.set_decode_impl("auto")
        if runs["kernel"] != runs["plain"]:
            raise AssertionError(f"generate cross-check fp32 [{cache}]: "
                                 f"kernel {runs['kernel']} vs plain "
                                 f"{runs['plain']}")
        log(f"generate cross-check fp32 [{cache} cache]: kernel and plain "
            f"greedy tokens identical ({new} tokens: "
            f"{_tokens_text(runs['kernel'][len(prompt):])[:40]!r})")
        del model
        torch.cuda.empty_cache()

    prompts = ["__global__ void", "int ", "#include <", "template <int D>"]
    ops.reset_launches()
    t0 = time.monotonic()
    completions, elapsed, step = bench.serve_checkpoint(
        d, prompts, max_new_tokens=32, max_slots=4, decode_burst=1)
    torch.cuda.synchronize()
    statuses = [c.status for c in completions]
    if len(completions) != len(prompts) or set(statuses) - {"length",
                                                             "eos"}:
        raise AssertionError(f"serve --ckpt_dir: statuses {statuses}")
    got = {k: v for k, v in ops.LAUNCHES.items() if v}
    if set(got) != {"decode_attention"}:
        raise AssertionError(f"serve --ckpt_dir: launches {got}")
    tokens = sum(len(c.tokens) for c in completions)
    log(f"serve --ckpt_dir (step {step}, slot engine, 4 slots): "
        f"{len(prompts)} requests all complete ({statuses}), {tokens} "
        f"tokens in {elapsed:.2f} s, launches {got}; TTFT "
        + ", ".join(f"{c.ttft * 1e3:.1f}" for c in completions) + " ms")
    return launches


# ------------------------------------------ MoE decode and serving (A10)
# serving lm_moe at lm_base width: the lm_moe_tc layers (MOE: 12 blocks of
# d 768, 12 heads of 64, mlp 3072, every second routed over 8 experts,
# top-2), RoPE, vocabulary 256; router biases drawn N(0, 0.5) so the
# bias takes part in every routing (a trained model's are not zero)
MOE_SERVE_REQUESTS = 8
MOE_BIAS_STD = 0.5
# J at the sorted decode path's shapes (m = slots x top-2 rows a decode
# step, bucket x top-2 a prefill) over 8 experts, empty groups included
J_DECODE_SIZES = {
    "decode 4 slots": [2, 0, 1, 1, 0, 2, 1, 1],
    "decode 8 slots": [4, 0, 3, 2, 0, 1, 5, 1],
    "prefill bucket 64": [30, 2, 0, 40, 16, 8, 12, 20],
    "prefill bucket 256": [100, 60, 0, 90, 80, 30, 70, 82],
}
# the registry's lm_moe (d 256, 4 blocks, 8 heads of 32) trained through
# the CLI for the checkpoint leg: a manifest rebuilds the registry's
# widths and heads, as the reference's does
MOE_CKPT_ARGS = ["--model", "lm_moe", "--pos_emb", "rope", "--precision",
                 "bf16", "--optimizer", "adamw", "--lr", "3e-4",
                 "--seq_len", "256", "-b", "8", "-e", "1", "--log_every",
                 "0", "--max_steps", "6", "--dataset", "text", "--data_dir",
                 "ddp_practice_tpu_torch/csrc"]


def _moe_serving_model(torch, *, precision, impl="einsum", router="topk",
                       seed=2):
    """lm_moe at lm_base width for serving (see MOE_SERVE_REQUESTS), its
    routed layers on `impl`; expert choice at capacity factor 1.0."""
    from ddp_practice_tpu_torch.config import PrecisionPolicy
    from ddp_practice_tpu_torch.models import create_model
    from ddp_practice_tpu_torch.ops.moe import moe_layers

    cfg = dict(MOE, moe_router=router)
    if router == "expert_choice":
        cfg["capacity_factor"] = 1.0
    model = create_model("lm_moe", policy=PrecisionPolicy.from_name(
        precision), device="cuda", seed=seed, vocab_size=256,
        max_len=SERVE["max_len"], pos_emb="rope", **cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in moe_layers(model):
            layer.impl = impl
            if layer.router_bias is not None:
                layer.router_bias.copy_(
                    torch.randn(layer.router_bias.shape, generator=g)
                    * MOE_BIAS_STD)
    return model


def _count_applications(model):
    """A forward pre-hook counting the model's applications: {"step":
    single-token, "prefill": longer}; returns (counts, the hook's
    handle)."""
    counts = {"step": 0, "prefill": 0}

    def hook(_module, args, kwargs):
        counts["step" if args[0].shape[1] == 1 else "prefill"] += 1

    return counts, model.register_forward_pre_hook(hook, with_kwargs=True)


def moe_serve_phase(torch, ops):
    """serve_bench over lm_moe at lm_base width, bf16, token choice on the
    einsum path: every request of the slot, static and paged rows
    completes, and each row launches its kernel (A, A, C) depth x its
    decode steps times and nothing else."""
    from ddp_practice_tpu_torch.serve.bench import serve_bench

    model = _moe_serving_model(torch, precision="bf16")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.monotonic()
    report = serve_bench(model=model, n_requests=MOE_SERVE_REQUESTS,
                         rate_hz=16.0, seed=0, paged=True, **SERVE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(ops.LAUNCHES)
    rows = [report["continuous"], report["static"], report["paged"]]
    log(f"moe serve[lm_moe at lm_base width, 6 of 12 blocks routed, top-2 "
        f"of 8, bias N(0, {MOE_BIAS_STD}), bf16, einsum] on "
        f"{report['device']}: {MOE_SERVE_REQUESTS} requests, wall "
        f"{wall:.1f} s, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{CARD}]")
    for r in rows:
        log(_row_line(r))
    log(f"  paged/static {report['paged_vs_static']:.2f}x  "
        f"paged/continuous {report['paged_vs_continuous']:.2f}x")
    _check_rows(rows, MOE_SERVE_REQUESTS, model.depth, {
        "continuous": "decode_attention", "static": "decode_attention",
        "paged": "paged_decode_attention"})
    del model
    torch.cuda.empty_cache()
    return report, launches


def _j_decode_shapes(torch, gm):
    """J against gmm_plain at the sorted decode path's shapes
    (J_DECODE_SIZES), bf16 and fp32, both expert products; the 8-slot
    decode step's bf16 w_in product timed (kernel, plain, library).
    Returns the timed row."""
    e = MOE["num_experts"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    timed_row = None
    seed = 7000
    for label, sizes in J_DECODE_SIZES.items():
        assert len(sizes) == e
        m = sum(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        for k, n in ((768, 3072), (3072, 768)):
            for dtype in ("bfloat16", "float32"):
                seed += 1
                g = torch.Generator(device="cuda").manual_seed(seed)
                tdt = getattr(torch, dtype)
                lhs = torch.randn((m, k), generator=g,
                                  device="cuda").to(tdt)
                rhs = (torch.randn((e, k, n), generator=g, device="cuda")
                       * k ** -0.5).to(tdt)
                want = gm.gmm(lhs, rhs, gs, impl="plain")
                got = gm.gmm(lhs, rhs, gs, impl="kernel")
                err, rel = _gmm_err(torch, "gmm", got, want, dtype,
                                    f"{label} m={m} k={k} n={n}")
                line = (f"  J {label:<18} m={m:<4} k={k:<4} n={n:<4} "
                        f"{dtype:>8}: err {err:.2e} rel {rel:.2e}")
                if (label == "decode 8 slots" and dtype == "bfloat16"
                        and k == 768):
                    bound, by = _gmm_bound_ms(
                        m, k, n, e, dtype,
                        e_read=sum(s > 0 for s in sizes))
                    lib_name, lib = _gmm_library(torch, "gmm", lhs, rhs,
                                                 None, gs, want)
                    timed_row = dict(
                        ms=_time_ms(torch, lambda: gm.gmm(
                            lhs, rhs, gs, impl="kernel"), flush),
                        plain_ms=_time_ms(torch, lambda: gm.gmm(
                            lhs, rhs, gs, impl="plain"), flush),
                        library_ms=_time_ms(torch, lib, flush),
                        library=lib_name, bound_ms=bound, bound_by=by)
                    line += (f"  kernel {timed_row['ms']:.4f} ms  plain "
                             f"{timed_row['plain_ms']:.4f} ms  library "
                             f"{timed_row['library_ms']:.4f} ms "
                             f"({lib_name})  bound {bound:.4f} ms ({by})")
                log(line)
    return timed_row


def moe_sorted_decode_leg(torch, ops, gm):
    """The dropless sorted path at decode (impl="sorted", kernel J for the
    two expert products of every routed block, prefill and single-token
    steps alike): J against its plain version at those shapes, then
    lm_moe at lm_base width in fp32 serves a trace through the slot engine
    (fake clock, every request queued up front) and its greedy tokens
    equal `generate`'s, each request alone; J launches 2 x 6 routed
    blocks x the model's applications and A 12 x its single-token steps.
    Returns J's launches."""
    from ddp_practice_tpu_torch.inference import make_generate_fn
    from ddp_practice_tpu_torch.serve import (
        EngineConfig, FakeClock, Request, Scheduler, SlotEngine,
    )
    from ddp_practice_tpu_torch.serve.bench import build_trace

    log("moe sorted decode: J against gmm_plain at the decode and prefill "
        "shapes (8 experts):")
    timed = _j_decode_shapes(torch, gm)

    model = _moe_serving_model(torch, precision="fp32", impl="sorted",
                               seed=3)
    routed = sum(b.use_moe for b in model.blocks)
    trace = build_trace(n_requests=6, rate_hz=8.0, vocab=256,
                        prompt_len_range=(4, 60), max_new_range=(8, 24),
                        seed=3)
    cfg = EngineConfig(max_slots=4, max_len=512, prompt_buckets=(16, 64),
                       decode_burst=4)
    apps, handle = _count_applications(model)
    ops.reset_launches()
    gm.reset_launches()
    t0 = time.monotonic()
    sched = Scheduler(SlotEngine(model, cfg), clock=FakeClock(),
                      max_queue=64)
    for t in trace:
        sched.submit(Request(rid=t["rid"], prompt=t["prompt"],
                             max_new_tokens=t["max_new_tokens"]))
    served = {c.rid: list(c.tokens) for c in sched.run_until_idle()}
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    handle.remove()
    j = gm.LAUNCHES["gmm"]
    got = {k: v for k, v in {**ops.LAUNCHES, **gm.LAUNCHES}.items() if v}
    generated = {}
    for t in trace:
        gen = make_generate_fn(model, max_new_tokens=t["max_new_tokens"],
                               temperature=0.0)
        out = gen(torch.tensor([t["prompt"]]))[0].tolist()
        generated[t["rid"]] = out[len(t["prompt"]):]
    if generated != served:
        diff = [r for r in served if generated.get(r) != served[r]]
        raise AssertionError(f"moe sorted decode: the slot engine's greedy "
                             f"tokens differ from generate's: rids {diff}")
    want = {"gmm": 2 * routed * (apps["step"] + apps["prefill"]),
            "decode_attention": model.depth * apps["step"]}
    if got != want:
        raise AssertionError(f"moe sorted decode: launches {got}, want "
                             f"{want} ({apps})")
    n = sum(len(v) for v in served.values())
    log(f"moe sorted decode (fp32, lm_base width): slot engine {len(trace)} "
        f"requests, {n} tokens in {wall:.1f} s; greedy tokens equal "
        f"generate's, one request at a time; launches {got} = 2 x {routed} "
        f"routed blocks x {apps['step'] + apps['prefill']} applications "
        f"and {model.depth} x {apps['step']} steps [{CARD}]")
    del model
    torch.cuda.empty_cache()
    return j, timed


def moe_expert_choice_leg(torch, ops):
    """Expert choice at decode (per-token top-k over the gates, capacity t,
    raw gates): lm_moe at lm_base width in fp32 generates greedily for
    four left-padded prompts (finite logits, the prompt copied through,
    kernel A depth x steps); each prompt alone through `generate` and all
    four through the slot engine give the same tokens (nothing drops)."""
    from ddp_practice_tpu_torch.inference import (
        make_generate_fn, pad_left_prompts,
    )
    from ddp_practice_tpu_torch.serve import (
        EngineConfig, FakeClock, Request, Scheduler, SlotEngine,
    )

    import numpy as np

    model = _moe_serving_model(torch, precision="fp32",
                               router="expert_choice", seed=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 17, 40, 9)]
    new = 24
    tokens, lens = pad_left_prompts(prompts)
    ops.reset_launches()
    t0 = time.monotonic()
    out = make_generate_fn(model, max_new_tokens=new, temperature=0.0)(
        tokens, prompt_lens=lens)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if tuple(out.shape) != (4, tokens.shape[1] + new):
        raise AssertionError(f"expert choice generate: shape "
                             f"{tuple(out.shape)}")
    if not (out[:, :tokens.shape[1]].cpu() == tokens).all():
        raise AssertionError("expert choice generate: prompt not copied")
    alone = {}
    for i, p in enumerate(prompts):
        one = make_generate_fn(model, max_new_tokens=new, temperature=0.0)(
            torch.tensor([p]))
        alone[i] = one[0, len(p):].tolist()
    sched = Scheduler(SlotEngine(model, EngineConfig(
        max_slots=4, max_len=512, prompt_buckets=(16, 64),
        decode_burst=4)), clock=FakeClock(), max_queue=8)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    served = {c.rid: list(c.tokens) for c in sched.run_until_idle()}
    batched = {i: out[i, tokens.shape[1]:].tolist() for i in range(4)}
    if served != alone or batched != alone:
        raise AssertionError(
            f"expert choice: tokens differ: engine {served != alone}, "
            f"left-padded batch {batched != alone}")
    if launches != {"decode_attention": model.depth * new}:
        raise AssertionError(f"expert choice generate: launches {launches}")
    log(f"moe expert choice generate (fp32, lm_base width, cf 1.0): 4 "
        f"left-padded prompts x {new} greedy tokens in {wall:.2f} s, "
        f"launches {launches}; each prompt alone, the batch and the slot "
        f"engine give the same tokens")
    del model
    torch.cuda.empty_cache()


def moe_checkpoint_leg(torch, ops):
    """lm_moe at the registry's widths trains 6 steps through the CLI
    (MOE_CKPT_ARGS: token choice, its router biases moved by every step)
    with a checkpoint at the end; `load_lm` restores the biases, fp32,
    non-zero and equal to the trained ones; generate.py greedy and
    serve/bench.py `--ckpt_dir` (4 prompts, slot engine) complete from
    it. Its 8 heads of 32 do not pack, so its single-token steps take
    the plain masked path (as the reference's), and no decode kernel
    launches."""
    import contextlib
    import io

    import ddp_practice_tpu_torch.generate as generate
    from ddp_practice_tpu_torch import checkpoint as ckpt
    from ddp_practice_tpu_torch.ops.moe import moe_layers
    from ddp_practice_tpu_torch.serve import bench

    d = "build/smoke_ckpt/lm_moe"
    shutil.rmtree(d, ignore_errors=True)
    trainer = _cli_trainer(MOE_CKPT_ARGS + ["--ckpt_dir", d])
    t0 = time.monotonic()
    summary = trainer.fit()
    torch.cuda.synchronize()
    trained = [m.router_bias.detach().cpu().clone()
               for m in moe_layers(trainer.model)]
    log(f"moe checkpoint leg: lm_moe (registry widths) rope bf16 trained "
        f"{summary['steps']} steps in {time.monotonic() - t0:.1f} s, "
        f"checkpoints at {ckpt.all_steps(d)}, moe_drop_rate "
        f"{summary.get('moe_drop_rate', float('nan')):.4f}")
    del trainer
    torch.cuda.empty_cache()
    model, step = generate.load_lm(d)
    restored = [m.router_bias.detach().cpu() for m in moe_layers(model)]
    if (len(restored) != len(trained) or any(
            r.dtype != torch.float32 or not torch.equal(r, t)
            for r, t in zip(restored, trained))):
        raise AssertionError("moe checkpoint: restored router biases differ "
                             "from the trained ones")
    if not all(bool(r.abs().max() > 0) for r in restored):
        raise AssertionError("moe checkpoint: a router bias is all zero")
    del model
    torch.cuda.empty_cache()
    ops.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        generate.main(["--ckpt_dir", d, "--prompt", "__global__ void",
                       "--max_new_tokens", "32", "--temperature", "0"])
    prompts = ["__global__ void", "int ", "#include <", "template <int D>"]
    completions, elapsed, _ = bench.serve_checkpoint(
        d, prompts, max_new_tokens=32, max_slots=4, decode_burst=1)
    torch.cuda.synchronize()
    statuses = [c.status for c in completions]
    if len(completions) != len(prompts) or set(statuses) - {"length",
                                                             "eos"}:
        raise AssertionError(f"moe serve --ckpt_dir: statuses {statuses}")
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launched:
        raise AssertionError(f"moe checkpoint: launches {launched} at "
                             f"head_dim 32")
    log(f"moe checkpoint (step {step}): router biases restored (fp32, "
        f"|b| max {max(float(r.abs().max()) for r in restored):.3f}, equal "
        f"to the trained ones); generate greedy "
        f"{out.getvalue().strip()[:40]!r}; serve --ckpt_dir {len(prompts)} "
        f"requests all complete ({statuses}) in {elapsed:.2f} s")
    shutil.rmtree(d, ignore_errors=True)


def build_loader() -> None:
    """Build (or load) the native batch gather from
    csrc/dataloader.cpp into build/; raises if it cannot."""
    from ddp_practice_tpu_torch.data import native_loader

    t0 = time.monotonic()
    native_loader.require()
    log(f"native loader {native_loader.library_path().name} from "
        f"{native_loader.SOURCE.name} ready in {time.monotonic() - t0:.1f} "
        f"s")


def a2_legs(torch):
    """ROADMAP A2's legs: ResNet-50's step on the card against the host
    CPU, then ResNet-18 (resident and host) and ResNet-50 (its corpus
    under build/, deleted by `a2_profiles`). Returns what `a2_profiles`
    needs."""
    import tempfile

    resnet50_step_check(torch)
    r18, _ = resnet18_legs(torch)
    os.makedirs("build", exist_ok=True)
    data_dir = tempfile.mkdtemp(prefix="smoke_imagenet_", dir="build")
    try:
        r50, _ = resnet50_leg(torch, data_dir)
    except BaseException:
        shutil.rmtree(data_dir, ignore_errors=True)
        raise
    return r18, r50, data_dir


def a2_profiles(torch, r18, r50, data_dir):
    """The ResNets' profiles: 5 replayed ResNet-18 steps after the host
    wall of 20, one eager ResNet-50 step; then the corpus goes."""
    try:
        image_profile_resident(torch, r18, "bf16, resident", n=20, m=5)
        image_profile(torch, r50, "bf16, eager host step")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


# the A8e phase (ROADMAP A8e-1, A8e-2): lm_base at full width, bf16,
# seq 512, for the elastic and watchdog legs; the sharded legs cut lm_base
# and lm_pipe to 4 blocks (A8E_CUT) at lm_base's widths
A8E_LM = ["--model", "lm_base", "--attn_impl", "flash", "--precision",
          "bf16", "--optimizer", "sgd", "--lr", "1e-2", "--momentum", "0.9",
          "--seq_len", "512", "-b", "4", "--log_every", "0",
          "--synthetic_size", "200000"]
A8E_CUT = dict(hidden_dim=768, depth=4, num_heads=12, mlp_dim=3072)
A8E_MOE = ["--model", "lm_moe", "--precision", "bf16", "--seq_len", "512",
           "-b", "8", "-e", "1", "--max_steps", "8", "--optimizer",
           "adamw", "--lr", "1e-3", "--log_every", "0", "--synthetic_size",
           "200000", "--num_experts", "8"]
# the sharded legs on threads: (label, model flags, ranks)
A8E_SHARDED = [
    ("tensor 2", ["--tensor", "2"], 2),
    ("pipe 2 x data 2 --fsdp 1f1b", ["--model", "lm_pipe", "--pipe", "2",
                                     "--fsdp", "--pipe_schedule", "1f1b",
                                     "--microbatches", "2", "-b", "2"], 4),
]
# fused "auto": the per-op path under several ranks (the reference's
# single-device gate, models/vit.py `_auto_fuse`), so H and I stay out
A8E_VIT = ["--model", "vit_tiny", "--dataset", "cifar10", "--precision",
           "bf16", "-b", "64", "--optimizer", "adam", "--lr", "1e-4",
           "--synthetic_size", "2048", "-e", "1", "--log_every", "0",
           "--data_dir", "build/no_such_data"]


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def elastic_leg(torch, fa) -> dict:
    """`fit` with --max_restarts 1 and a checkpoint each epoch, its first
    attempt dying after epoch 0's save (tests/elastic_worker.py's
    sabotage): the resumed attempt's parameters against an uninterrupted
    run's, bit for bit."""
    import tempfile

    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train import loop

    os.makedirs("build", exist_ok=True)
    ck = tempfile.mkdtemp(dir="build")
    cfg = config_from_args(build_parser().parse_args(
        A8E_LM + ["-e", "2", "--max_steps", "3", "--ckpt_dir", ck,
                  "--max_restarts", "1"])).replace(checkpoint_every_epochs=1)
    original = loop.Trainer._fit_inner
    seen = {"attempts": 0}

    def sabotaged(self):
        seen["attempts"] += 1
        if seen["attempts"] == 1:
            self.train_epoch(0)
            self.save()
            raise RuntimeError("injected mid-training failure")
        seen["resumed_at"] = self.state.step
        out = original(self)
        seen["params"] = _params(self.model)
        return out

    _reset_launches(fa)
    t0 = time.monotonic()
    loop.Trainer._fit_inner = sabotaged
    try:
        summary = loop.fit(cfg)
    finally:
        loop.Trainer._fit_inner = original
        shutil.rmtree(ck, ignore_errors=True)
    wall = time.monotonic() - t0
    launches = _launches(fa.LAUNCHES)
    plain = loop.Trainer(cfg.replace(checkpoint_dir=None, max_restarts=0))
    want = plain.fit()
    same = all(torch.equal(seen["params"][n], p.detach())
               for n, p in plain.model.named_parameters())
    log(f"a8e[elastic] lm_base bf16 sgd, seq 512, b 4, 2 epochs of 3 steps, "
        f"--max_restarts 1, a checkpoint each epoch, attempt 1 killed after "
        f"epoch 0's save: {seen['attempts']} attempts, resumed at step "
        f"{seen['resumed_at']}, {summary['steps']} steps, perplexity "
        f"{summary['perplexity']:.4f} (uninterrupted {want['perplexity']:.4f}"
        f"); final parameters {'equal' if same else 'DIFFER from'} the "
        f"uninterrupted run's bit for bit; E/F/G launches {launches}; wall "
        f"{wall:.1f} s [{CARD}]")
    if not (seen["attempts"] == 2 and seen["resumed_at"] == 3
            and summary["steps"] == 6 and same):
        raise AssertionError(f"a8e[elastic]: {seen.get('resumed_at')}, "
                             f"{summary['steps']}, equal {same}")
    del plain, seen
    torch.cuda.empty_cache()
    return launches


def watchdog_leg(torch, fa) -> dict:
    """A resident lm_base run with the watchdog on (whole-epoch calls
    capped at the probe interval, graph replays, no firing), then a probe
    of a rung held behind a spin kernel longer than the timeout: the
    watchdog's `on_timeout` fires (a callback here, not the default
    exit)."""
    from ddp_practice_tpu_torch.cli import build_parser, config_from_args
    from ddp_practice_tpu_torch.train.elastic import Rung, StepWatchdog
    from ddp_practice_tpu_torch.train.loop import Trainer

    fired, probes = [], []
    default, probe = StepWatchdog._default_timeout, StepWatchdog.probe
    StepWatchdog._default_timeout = staticmethod(fired.append)
    StepWatchdog.probe = lambda self, v, fetch=None: (
        probes.append(v), probe(self, v, fetch))
    _reset_launches(fa)
    t0 = time.monotonic()
    try:
        cfg = config_from_args(build_parser().parse_args(
            A8E_LM + ["-e", "1", "--max_steps", "8", "--steps_per_call",
                      "-1", "--watchdog", "120", "--data_placement",
                      "device"])).replace(watchdog_probe_every_steps=4)
        trainer = Trainer(cfg)
        cap = trainer._resident_group(8)
        summary = trainer.fit()
        graph = trainer.resident_train_step.graph
    finally:
        StepWatchdog._default_timeout = staticmethod(default)
        StepWatchdog.probe = probe
    launches = _launches(fa.LAUNCHES)
    log(f"a8e[watchdog] lm_base bf16, 8 steps, --steps_per_call -1 "
        f"--watchdog 120, probe every 4 steps: group cap {cap} steps a "
        f"call, {graph.captures} capture(s), {graph.replays} replays, "
        f"{len(probes)} probes on CUDA-event rungs, "
        f"{'no firing' if not fired else f'FIRED {fired}'}, {summary['steps']} "
        f"steps; E/F/G launches (wrappers + replays) {launches}; wall "
        f"{time.monotonic() - t0:.1f} s [{CARD}]")
    if fired or cap != 4 or summary["steps"] != 8 or not probes:
        raise AssertionError(f"a8e[watchdog]: cap {cap}, fired {fired}")
    del trainer
    torch.cuda.empty_cache()

    stalled = []
    wd = StepWatchdog(0.5, on_timeout=stalled.append).start()
    wd.beat()
    torch.cuda._sleep(int(4e9))        # ~2 s of spinning ahead of the rung
    rung = Rung(torch.device("cuda", torch.cuda.current_device()))
    t0 = time.monotonic()
    wd.probe(rung)
    waited = time.monotonic() - t0
    wd.stop()
    log(f"a8e[watchdog, stalled] a rung behind torch.cuda._sleep(4e9), "
        f"timeout 0.5 s: the probe waited {waited:.2f} s, on_timeout fired "
        f"{len(stalled)} time(s) after {stalled[0] if stalled else 0:.2f} s "
        f"without a beat [{CARD}]")
    if len(stalled) != 1 or waited < 0.5:
        raise AssertionError(f"a8e[watchdog, stalled]: {stalled}, {waited}")
    return launches


def sorted_moe_captured_leg(torch, gm) -> dict:
    """A resident lm_moe step on the sorted path (J and K) captured and
    replayed, against the eager host steps: the losses bit for bit."""
    from ddp_practice_tpu_torch.ops.moe import moe_layers
    from ddp_practice_tpu_torch.utils import graphs

    legs = {}
    for label, extra in (("host", ["--data_placement", "host"]),
                         ("resident", ["--steps_per_call", "4",
                                       "--data_placement", "device"])):
        trainer = _cli_trainer(A8E_MOE + extra)
        for m in moe_layers(trainer.model):
            m.impl = "sorted"
        losses, _, k, graph, unwrap = _record_calls(torch, trainer)
        _reset_launches(gm)
        trainer.train_epoch(0)
        legs[label] = ([float(x) for x in losses], k, graph,
                       dict(gm.LAUNCHES), dict(graphs.REPLAYED),
                       _params(trainer.model))
        unwrap()
        del trainer
        torch.cuda.empty_cache()
    host, res = legs["host"], legs["resident"]
    want = [host[0][i * 4 + 3] for i in range(2)]
    same_params = all(torch.equal(res[5][n], w) for n, w in host[5].items())
    graph = res[2]
    replayed = {k: v for k, v in res[4].items() if k in gm.LAUNCHES}
    log(f"a8e[sorted moe captured] lm_moe (d 256, 8 experts, top-2) bf16 "
        f"adamw, seq 512, b 8, 8 steps, impl sorted: resident 4 steps a "
        f"call, {graph.captures} capture(s), {graph.replays} replays; "
        f"losses at steps 4, 8 {res[0]} vs eager host {want} "
        f"({'bit-identical' if res[0] == want else 'DIFFERENT'}); "
        f"parameters {'bit-identical' if same_params else 'differ'}; J/K "
        f"launches: eager {res[3]}, replayed {replayed} [{CARD}]")
    if (res[0] != want or graph.captures != 1 or graph.replays != 7
            or not all(replayed.get(k) for k in ("gmm", "gmm_trhs",
                                                 "tgmm"))):
        raise AssertionError("a8e[sorted moe captured]: off the eager leg")
    return {k: res[3][k] + replayed.get(k, 0) for k in res[3]}


def _a8e_rank_run(torch, argv, tallies):
    """One rank of a sharded leg: 4 single steps from host batches, then
    a call of 4 chunked steps; (losses, last chunk loss, whole params of
    each, each's launches by this rank)."""
    from ddp_practice_tpu_torch.parallel.mesh import full_parameters

    out = []
    for extra in (["--data_placement", "host"],
                  ["--data_placement", "host", "--steps_per_call", "4"]):
        trainer = _cli_trainer(argv + ["-e", "1", "--max_steps", "4"]
                               + extra)
        losses, _, _, _, _ = _record_calls(torch, trainer)
        if trainer.chunk_step is not None:
            chunk = trainer.chunk_step

            def recorded(state, batch, chunk=chunk):
                state, metrics = chunk(state, batch)
                losses.append(metrics["loss"])
                return state, metrics

            trainer.chunk_step = recorded
        before = [dict(t.mine()) for t in tallies]
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        launched = {}
        for t, b in zip(tallies, before):
            launched.update({k: v - b.get(k, 0) for k, v in t.mine().items()
                             if v != b.get(k, 0)})
        out.append(([float(x) for x in losses], launched,
                    full_parameters(trainer.model)
                    if hasattr(trainer.model, "sharding")
                    else _params(trainer.model),
                    trainer.chunk_step is not None))
        del trainer
    return out


def sharded_chunked_leg(torch, fa, fe) -> dict:
    """K = 4 chunked steps against 4 single steps on ranks as threads of
    this process (eager by utils/graphs.py's rule: the threaded group's
    collectives are host copies), bit for bit, with each rank's kernel
    launches: lm_base at tensor 2 and lm_pipe at pipe 2 x data 2 with
    FSDP under 1F1B (both cut to 4 blocks at lm_base's widths), and
    vit_tiny at data 2 (DDP, the per-op blocks: "auto" fuses on one rank
    only)."""
    from ddp_practice_tpu_torch.parallel.threads import run_ranks
    from ddp_practice_tpu_torch.train import loop
    from ddp_practice_tpu_torch.utils.graphs import eager_reason

    counts = (fa.LAUNCHES, fe.LAUNCHES)
    tallies = fa.LAUNCHES, fe.LAUNCHES = (
        _RankTally({k: 0 for k in fa.LAUNCHES}),
        _RankTally({k: 0 for k in fe.LAUNCHES}))
    make = loop.create_model
    total = {}
    try:
        legs = [(label, A8E_LM + argv, world, A8E_CUT)
                for label, argv, world in A8E_SHARDED]
        legs.append(("vit_tiny data 2", A8E_VIT, 2, {}))
        for label, argv, world, fields in legs:
            loop.create_model = (lambda name, fields=fields, **kw: make(
                name, **{**kw, **fields}))
            reason = []

            def rank(r, argv=argv):
                if r == 0:
                    reason.append(eager_reason(torch.nn.Linear(
                        1, 1, device="cuda")))
                return _a8e_rank_run(torch, argv, tallies)

            t0 = time.monotonic()
            res = run_ranks(rank, world, timeout=600)
            (single, one_l, p1, _), (chunked, chunk_l, p2, is_chunk) = res[0]
            same = (chunked[-1] == single[3] and all(
                torch.equal(p1[n], p2[n]) for n in p1))
            for other in res[1:]:
                same = same and other[1][0][-1] == chunked[-1]
            log(f"a8e[sharded chunked, {label}] {world} ranks as threads "
                f"sharing one card, 4 chunked steps (one call) vs 4 single "
                f"steps, eager by rule ({reason[0]}): losses {single} vs "
                f"the call's "
                f"{chunked[-1]}; parameters "
                f"{'bit-identical' if same else 'DIFFERENT'}; launches in "
                f"the call by rank {[r[1][1] for r in res]}; wall "
                f"{time.monotonic() - t0:.1f} s [{CARD}]")
            if not (same and is_chunk):
                raise AssertionError(f"a8e[sharded chunked, {label}]")
            for r in res:
                for k, v in r[1][1].items():
                    total[k] = total.get(k, 0) + v
            del res
            torch.cuda.empty_cache()
    finally:
        loop.create_model = make
        fa.LAUNCHES, fe.LAUNCHES = counts
    return total


def devices_leg(torch) -> None:
    """--devices 1 is the plain one-card run; --devices 2 on one card
    raises instead of taking fewer."""
    from ddp_practice_tpu_torch import cli

    argv = A8E_LM + ["-e", "1", "--max_steps", "2"]
    assert cli.main(["--devices", "1"] + argv) == 0
    msg = "(two cards visible: not checked)"
    if torch.cuda.device_count() < 2:
        try:
            cli.main(["--devices", "2"] + argv)
        except ValueError as e:
            msg = f"raises: {e}"
        else:
            raise AssertionError("--devices 2 ran on one card")
    log(f"a8e[devices] --devices 1 trained 2 steps on the card; "
        f"--devices 2 {msg} [{CARD}]")


def a8e_phase(torch, fa, fe, gm) -> dict:
    """ROADMAP A8e on one card (the docstring's phase 32)."""
    t0 = time.monotonic()
    flash = {}
    for leg in (elastic_leg(torch, fa), watchdog_leg(torch, fa)):
        for k, v in leg.items():
            flash[k] = flash.get(k, 0) + v
    gmm = sorted_moe_captured_leg(torch, gm)
    sharded = sharded_chunked_leg(torch, fa, fe)
    devices_leg(torch)
    launches = {k: flash.get(k, 0) + sharded.get(k, 0)
                for k in set(flash) | set(sharded)}
    launches.update(gmm)
    wall = time.monotonic() - t0
    log(f"a8e phase: launches (all legs, wrappers + replays) {launches}; "
        f"wall {wall:.1f} s")
    return {"launches": launches, "wall_s": wall}


def main() -> int:
    t_start = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from ddp_practice_tpu_torch.ops import cuda_build
    from ddp_practice_tpu_torch.ops import decode_attention as ops
    from ddp_practice_tpu_torch.ops import flash_attention as fa
    from ddp_practice_tpu_torch.ops import fused_encoder as fe
    from ddp_practice_tpu_torch.ops import grouped_matmul as gm
    from ddp_practice_tpu_torch.utils.flops import chip_hbm_bandwidth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    global CARD
    CARD = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = chip_hbm_bandwidth(torch.cuda.get_device_name(0))
    if HBM_BYTES_PER_S is None:
        raise RuntimeError(
            f"no memory rate for {torch.cuda.get_device_name(0)!r} in "
            f"utils/flops.chip_hbm_bandwidth: the bytes bounds need it")
    t0 = time.monotonic()
    cuda_build.build(cuda_build.SOURCES)
    log(f"built {SOURCE} (kernels A-D), {FLASH_SOURCE} (E-G, E's variants), "
        f"{FUSED_SOURCE} (H, I) and {GMM_SOURCE} (J, K) for sm_90a in "
        f"{time.monotonic() - t0:.1f} s")
    for name, info in cuda_build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    kernel_resources(cuda_build, fa, gm, fe)
    build_loader()

    # ROADMAP A8a: the sharded legs first, before any trace (their steps
    # are eager and their ranks threads of this process)
    par = parallel_phase(torch, fa, ops)
    seq = seq_phase(torch, fa, par)
    expert = expert_phase(torch, fa, gm, ops)
    pipe = pipe_phase(torch, fa)
    a8e = a8e_phase(torch, fa, fe, gm)

    # the MoE decode legs are host-bound:
    # they run before any torch.profiler trace, which leaves host time on
    # every later launch in the process (experiments/convnet_step.py)
    _, moe_launches = moe_serve_phase(torch, ops)
    moe_j, _ = moe_sorted_decode_leg(torch, ops, gm)
    moe_expert_choice_leg(torch, ops)
    moe_checkpoint_leg(torch, ops)
    log(f"MoE decode paths' launches: serve {moe_launches}, sorted decode "
        f"J {moe_j}")
    router_launches = router_phase(torch, ops)
    door_launches = frontdoor_phase(torch, ops)
    elastic_launches = elastic_phase(torch, ops)

    # the ConvNet's eager steps first: a finished torch.profiler trace
    # adds host time to every later launch in the process
    # (experiments/convnet_step.py), and the flash experiments trace
    conv32, res32 = convnet_train_phase(
        torch, [], label="config 1, fp32, auto = resident")
    conv_host, host32 = convnet_train_phase(
        torch, ["--data_placement", "host", "-e", "1"],
        label="config 1, fp32, host, one epoch")
    held, worst, exact = _agree("convnet", host32["loss"][:50],
                                res32["loss"][:50], 1, 1e-6)
    log(f"convnet resident vs host (config 1, fp32): the first {held} "
        f"steps' losses agree, worst relative difference {worst:.2e} "
        f"({'bit-identical' if exact else 'not bit-identical'}); resident "
        f"{res32['images_per_s']:.0f} images/s per card, median step "
        f"{res32['step_ms']:.3f} ms; host {host32['images_per_s']:.0f} "
        f"images/s, {host32['step_ms']:.3f} ms; "
        f"{res32['images_per_s'] / host32['images_per_s']:.2f}x [{CARD}]")
    conv16, _ = convnet_train_phase(
        torch, ["--precision", "bf16", "-e", "1"],
        label="config 2's precision, bf16, one epoch, auto = resident",
        gate_accuracy=0.3)
    convnet_train_phase(torch, ["--data_dir", "tests/data/mini_mnist",
                                "-b", "16", "--optimizer", "adam", "--lr",
                                "3e-3"],
                        label="tests/data/mini_mnist", gate_accuracy=0.3)
    convnet_resume_leg(torch)
    image_profile_resident(torch, conv32, "fp32, resident")
    image_profile(torch, conv_host, "fp32, eager host step")
    image_profile(torch, conv16, "bf16, eager step")
    del conv32, conv16, conv_host
    # the ResNets' legs after the ConvNet's host-bound profiles (which
    # they would otherwise precede with two more trainers in memory);
    # their steps are device-bound, so the traces before them cost little
    a2_profiles(torch, *a2_legs(torch))
    torch.cuda.empty_cache()

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    log(f"kernel phase, flat cache (b, L, cur, dtype; device times are "
        f"medians of {TIMED_RUNS}):")
    timing_floor(torch, flush)
    main_rows = kernel_phase(torch, F, ops, flush)
    log(f"kernel phase, paged pool (block {BS}; device times are medians "
        f"of {TIMED_RUNS}):")
    main_rows.update(paged_kernel_phase(torch, F, ops, flush))
    log(f"kernel phase, flash attention (device times are medians of "
        f"{TIMED_RUNS}, plain of 5):")
    flash_rows = flash_kernel_phase(torch, F, fa, flush)
    log(f"kernel phase, flash variants (row #12; device times are medians "
        f"of {TIMED_RUNS}, plain of 5):")
    variant_rows = variant_phase(torch, F, fa, cuda_build, flush)
    log(f"kernel phase, fused encoder layer (device times are medians of "
        f"{TIMED_RUNS}, plain of 5):")
    fused_rows = fused_kernel_phase(torch, fe, flush)
    log(f"kernel phase, grouped matmul (device times are medians of "
        f"{TIMED_RUNS}):")
    gmm_rows = gmm_kernel_phase(torch, gm, flush)
    del flush
    torch.cuda.empty_cache()

    vit_trainer, vit_host = vit_train_phase(
        torch, fe, ["--data_placement", "host"], steps=VIT_STEPS,
        label="fused auto, host", fused=True)
    vit_train_profile(torch, vit_trainer, "fused auto")
    del vit_trainer
    torch.cuda.empty_cache()
    vit_trainer, vit = vit_train_phase(torch, fe, [], steps=VIT_STEPS,
                                       label="fused auto, resident",
                                       fused=True)
    del vit_trainer
    held, worst, exact = _agree("vit", vit_host["loss"], vit["loss"], 1,
                                MODEL_BF16_LOSS)
    log(f"vit resident vs host (bf16, batch 1024): {held} steps' losses "
        f"agree, worst relative difference {worst:.2e} "
        f"({'bit-identical' if exact else 'not bit-identical'}); median "
        f"step resident {vit['step_ms']:.2f} ms, host "
        f"{vit_host['step_ms']:.2f} ms, "
        f"{vit_host['step_ms'] / vit['step_ms']:.3f}x; "
        f"{vit['images_per_s']:.0f} vs {vit_host['images_per_s']:.0f} "
        f"images/s [{CARD}]")
    torch.cuda.empty_cache()
    off_trainer, vit_off = vit_train_phase(
        torch, fe, ["--fused", "off", "--data_placement", "host"], steps=10,
        label="fused off, host", fused=False)
    vit_train_profile(torch, off_trainer, "fused off")
    del off_trainer
    log(f"vit train (host legs): fused auto {vit_host['step_ms']:.2f} "
        f"ms/step, fused off {vit_off['step_ms']:.2f} ms/step: the fused "
        f"layer's step is {vit_host['step_ms'] / vit_off['step_ms']:.2f}x "
        f"the per-op step's")
    torch.cuda.empty_cache()
    vit_cross_check(torch, fe)

    trainer, train_host = train_phase(
        torch, fa, ["--synthetic_size", "600000", "--data_placement",
                    "host"], steps=TRAIN_STEPS, label="learned, host",
        row="packed", metrics_file="build/train_metrics.jsonl")
    train_profile(torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    _, train = train_phase(
        torch, fa, ["--synthetic_size", "600000", "--steps_per_call", "10"],
        steps=20, label="learned, resident", row="packed")
    held, worst, exact = _agree("lm_base", train_host["loss"],
                                train["loss"], 10, MODEL_BF16_LOSS)
    log(f"lm_base resident vs host (bf16, b=8, s=2048): losses at steps "
        f"10 and 20 agree, worst relative difference {worst:.2e} "
        f"({'bit-identical' if exact else 'not bit-identical'}); median "
        f"step resident {train['step_ms']:.2f} ms, host "
        f"{train_host['step_ms']:.2f} ms, "
        f"{train_host['step_ms'] / train['step_ms']:.3f}x; "
        f"{train['tokens_per_s']:.0f} vs {train_host['tokens_per_s']:.0f} "
        f"tokens/s [{CARD}]")
    torch.cuda.empty_cache()
    train_phase(torch, fa, ["--pos_emb", "rope"], steps=10, label="rope",
                row="packed")
    _, folded = train_phase(torch, fa, ["--num_heads", "24"], steps=10,
                            label="24 heads of 32", row="folded")
    torch.cuda.empty_cache()
    train_phase(torch, fa, ["--synthetic_size", "600000"], steps=25,
                label="--profile_dir", row="packed",
                profile_dir="build/profiles/train")
    torch.cuda.empty_cache()
    train_cross_check(torch, fa)

    moe, *run = moe_train_phase(torch, fa, gm, impl="einsum",
                                steps=MOE_STEPS, label="einsum")
    moe_profile(torch, *run[1:], "einsum")
    del run
    torch.cuda.empty_cache()
    moe_sorted, *run = moe_train_phase(torch, fa, gm, impl="sorted",
                                       steps=MOE_STEPS, label="sorted")
    moe_profile(torch, *run[1:], "sorted")
    del run
    torch.cuda.empty_cache()
    log(f"moe train: einsum {moe['step_ms']:.2f} ms/step, sorted "
        f"{moe_sorted['step_ms']:.2f} ms/step: the sorted step is "
        f"{moe_sorted['step_ms'] / moe['step_ms']:.2f}x the einsum step's "
        f"(a reading, not a claim)")
    moe_cli_phase(torch)
    moe_cross_check(torch, gm)

    _, serve_launches = serve_phase(torch, ops, n_requests=12,
                                    kv_cache_dtype=None, paged=True)
    _, int8_launches = serve_phase(torch, ops, n_requests=6,
                                   kv_cache_dtype="int8", paged=False)
    shared_prefix_phase(torch, ops, n_requests=32, kv_int8=False)
    _, prefix8_launches = shared_prefix_phase(torch, ops, n_requests=16,
                                              kv_int8=True)
    spec_phase(torch, ops, n_requests=16)
    cross_check(torch)
    profile_phase(torch, "slot")
    profile_phase(torch, "paged")

    gen_launches = generate_serve_leg(torch, ops)
    log(f"kernels A and B on the checkpoint's generate path: {gen_launches}")
    log(f"the parallel phase's launches (all ranks): training "
        f"{par['launches']}, generate {par['generate_launches']}")
    log(f"the sequence phase's launches (all ranks): {seq['launches']}")
    log(f"the expert phase's launches (all ranks): {expert['launches']}")
    log(f"the pipeline phase's launches (all ranks): {pipe['launches']}")
    log(f"the A8e phase's launches (all legs): {a8e['launches']}")
    log(f"the router phase's launches (both legs): {router_launches}")
    log(f"the front door phase's launches (fp32 legs, rows and workers): "
        f"{door_launches}")
    log(f"the elastic phase's launches (live workers): {elastic_launches}")


    # each kernel's launches on its main path's run
    launches = {
        "decode_attention": serve_launches["decode_attention"]
        + moe_launches["decode_attention"]
        + router_launches["decode_attention"]
        + door_launches["decode_attention"]
        + elastic_launches["decode_attention"],
        "decode_attention_int8": int8_launches["decode_attention_int8"],
        "paged_decode_attention": serve_launches["paged_decode_attention"]
        + moe_launches["paged_decode_attention"]
        + door_launches["paged_decode_attention"]
        + elastic_launches["paged_decode_attention"],
        "paged_decode_attention_int8":
            prefix8_launches["paged_decode_attention_int8"],
        **{name: train["launches"][name] + seq["launches"][name]
           + expert["launches"][name] + pipe["launches"][name]
           + a8e["launches"].get(name, 0)
           for name in ("flash_fwd_packed", "flash_bwd_packed")},
        **{name: folded["launches"][name] + seq["launches"][name]
           + expert["launches"][name] + pipe["launches"][name]
           + a8e["launches"].get(name, 0)
           for name in ("flash_fwd_folded", "flash_bwd_folded")},
        **{name: vit["launches"][name] + a8e["launches"].get(name, 0)
           for name in ("fused_encoder_fwd", "fused_encoder_bwd")},
        **{name: moe_sorted["launches"][name] + expert["launches"][name]
           + a8e["launches"].get(name, 0)
           for name in GMM_REPLACES},
        "gmm": moe_sorted["launches"]["gmm"] + moe_j
        + expert["launches"]["gmm"] + a8e["launches"].get("gmm", 0),
        **{name: row["launches"] for name, row in variant_rows.items()},
    }
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
        })
    for name, row in flash_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for name, row in fused_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FUSED_SOURCE,
            "replaces": FUSED_REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for name, row in gmm_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": GMM_SOURCE,
            "replaces": GMM_REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    for name, row in variant_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": VARIANT_REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    log(f"chip_smoke wall {time.monotonic() - t_start:.1f} s (the kernels' "
        f"build included)")
    log(smi)   # name, power limit: as nvidia-smi prints them
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
