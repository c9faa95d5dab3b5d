#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
Phases, each of which fails the run on any mismatch:

1. The card: name and power limit from nvidia-smi, torch and CUDA
   versions. float32 matmuls stay full f32 (TF32 off for cuBLAS and
   cuDNN), so f32 comparisons are f32-exact up to summation order.
2. Build: every kernel under paddle_tpu_torch/csrc, compiled by nvcc
   for sm_90a into build/paddle_tpu_torch/ (one nvcc per source, all
   started together), with ptxas's register and spill report. A spill
   or a wgmma serialisation (ptxas C7515/C7512) in a head_dim-64 bf16
   wgmma kernel (fwd_wgmma, dq_wgmma, dkv_wgmma) fails the run, as do
   a spill in any of the 20 f32 FFMA kernels from head_dim 256
   (csrc/flash_attn_wide.cu), and a spill or a serialisation in any of
   the 12 head_dim-256 wgmma kernels or the 12 above it (phases 40 and
   43). From
   the built forward's SASS (cuobjdump -sass), the instructions per
   Philox4x32-10 call of the dropout kernel's keep-bit loop, for the
   forward's Philox floor (see 4).
3. Forward kernel: flash_attn_fwd against its plain PyTorch version at
   the inference path's shapes (ERNIE-base attention, b 32, s 512 and
   200, 12 heads of 64, read as strided views of a fused qkv tensor),
   causal and not, f32 (tolerance 1e-4) and bf16 (2e-2, the Pallas
   tests' bf16 tolerance), elementwise and row by row as in 4;
   head_dim 128 too, in bf16 also with dropout
   0.1 (the training path's shapes, phase 4, cover head_dim 64); and
   Transformer-base's attentions as MultiHeadAttention runs them: b 32,
   n 8, h 64 at the encoder's (sq 128, sk 128), the decoder's
   cross-attention (96, 128) and its mirror (128, 96), q, k and v
   separate contiguous tensors (the layout is a case's own field, not a
   consequence of sq and sk), f32 and bf16, dropout 0 and (bf16) 0.1.
   Times
   with CUDA events after warm-up: the kernel, the plain version, and
   torch's scaled_dot_product_attention at the same dropout p as the
   library yardstick (timed here only; the port never calls it).
4. Backward kernels and dropout: flash_attn_bwd_dq and flash_attn_bwd_dkv
   against flash_attention_bwd_plain at the training path's shapes (b 48,
   s 512 and 200, n 12, h 64, strided qkv views), causal and not, f32
   and bf16, head_dim 128, the Transformer-base cases of 3; with
   dropout p = 0.1 at a fixed seed the
   forward and the backward against the plain versions drawing the same
   Philox mask. Tolerance, row by row (a query row of O and dQ, a key
   row of dK and dV; a causal row holds about 1/sqrt(i + 1) of row 0):
   f32 max abs error of the row <= 1e-4 * max(1, max|ref_row|), bf16
   <= 2e-2 * max(max|ref_row|, ROW_FLOOR * max|ref|); the worst row's
   ratio is printed. A second dQ launch must give the same dq
   bit for bit, and every bf16 case holds the delta = rowsum(dO*O) that
   the dQ kernel computes against torch ops at 1e-3 x max(1,
   max|delta|) (f32 takes delta from those ops). Each backward kernel
   is timed against the plain version of its own outputs (dq, or dk
   and dv); the library yardstick, SDPA's forward + backward minus its
   forward, computes all three gradients and is reported for the whole
   backward only. Every bf16 case and every dropout case also holds the
   forward against its plain version and times it beside SDPA's forward
   at the same dropout p. The forward's bound (bytes and tensor-core
   flops) leaves out the dropout's integer work: beside it stand the
   Philox4x32-10 calls of the call (one per 2x2 block of links), their
   SASS instructions, and the floor they set at the SM's integer issue
   rate (64 ops per clock per SM, CUDA C++ Programming Guide's
   throughput table for compute capability 9.0, at the card's maximum
   SM clock from nvidia-smi).
   Mask probe: inputs on which each output element sums a few dropout
   links of equal weight run through the bf16 (tensor-core) and f32
   (FFMA) forward, dQ and dK/dV kernels at b 48, s 512 and 200, and
   at the Transformer-base shapes of 3 (b 32, separate q, k and v; the
   probe's weights are 1/sk a link); each
   must agree with the plain version to within half a link's weight,
   so the kernels' own masks equal the plain Philox mask link for link.
   The kept fraction over all links is reported too. `head_pad`: the
   autograd entry at head_dims the kernels lack (32 and 96, run
   zero-padded to 64 and 128), f32 and bf16 at p 0.1, O, lse and the
   three gradients against the plain versions at the unpadded head_dim,
   row by row; each kernel must launch. The kernels get
   the seed as a tensor on the card (seed_card), as a training step
   does; `host_cost` then times the forward wrapper's host side alone
   at GPT-2's 8x128 causal shape: at p 0, and at p 0.1 with an int seed
   (made into a card tensor at every call) and with a card-resident one.
5. Main path, inference: ERNIE-base (bench.py's base config: vocab
   30528, hidden 768, 12 layers, 12 heads, ffn 3072, 512 positions),
   random weights from seed 0, in eval mode on the card, answering
   request batches of 32x512, 32x128, 8x384 and 16x200 tokens in f32
   and then bf16 (model.to(torch.bfloat16)). Launch counts are zeroed
   just before and read just after; each forward must launch the
   attention kernel once per layer. Outputs must be finite and of the
   right shape; the card must match a CPU run of the same weights
   (plain path) on a 2x128 batch at 1e-3, and bf16 logits must stay
   within 5e-2 relative L2 of f32.
6. Main path, training: bench.py's ERNIE-base pretraining step,
   ErnieForPretraining (dropouts 0.1/0.1) + AdamW(1e-4, weight decay
   0.01) + TrainStep(amp_level="O1", amp_dtype="bfloat16") at batch
   48x512, ids and labels from numpy seed 0; 2 warm-up steps, then 10
   timed steps on a synchronised host clock. On the card a TrainStep
   captures its step as one CUDA graph at the first call (after an eager
   warm-up, which is that call's step) and replays it after, so every
   training phase runs captured: 1 graph, 0 sentinel events. Counts are
   zeroed just before the path. The first call's launches are the
   wrappers' count of its warm-up (TrainStep.last_launches); a replay
   does not pass through the wrappers, so after the timed steps two
   replays run under torch.profiler, which counts the kernels each ran
   on the card (`launches_per_step`; three such rounds, each kernel's
   largest count kept, since the profiler drops a record now and then,
   each round's window padded by PROFILE_PAD spin kernels, since it can
   lose the first records of a window).
   The warm-up and every replay
   must launch the forward, dQ and dK/dV kernels exactly 12 times each,
   and a replay the launches its capture recorded
   (TrainStep.capture_launches); `launches` sums the counted calls,
   `counted_calls` names them, `wrapper_counts` is the wrappers' own
   count (warm-up and capture).
   Losses finite, the last below the first (one batch, repeated). Step
   ms, tokens/s, MFU = tokens/s x (6N + 12 L h s) / 989e12 (bench.py's
   formula) and peak memory (torch.cuda.max_memory_allocated).
7. Card against CPU, training: 2 layers of the base width, batch 2x128,
   f32, dropout 0, 3 TrainStep steps from the same weights on the card
   and on the CPU (plain path): losses agree at 1e-3 relative.

8. Profile: the two profiled replays of 6, device time per step by
   kernel and by category (`profile` line). The run fails if the
   profiler sees no device time inside a replay.
9. GPT forward (`gpt_forward`): GPT-2 small as bench.py:306 defines it
   (vocab 50304, hidden 768, 12 layers, 12 heads of 64, 1024
   positions), random weights from seed 0, eval mode, at 8x1024 and
   8x128 in f32 and bf16. Counts are zeroed before each forward, which
   must launch the causal flash_attn_fwd exactly 12 times and nothing
   else. The card's logits against a CPU run of the same weights at
   2x128 (1e-3), bf16 against f32 (5e-2 relative L2), and the causal
   kernel at every shape the forwards give it (b 8, s 1024 and 128, n
   12, h 64, f32 and bf16) against its plain version, timed beside
   SDPA's causal forward, with its bound.
10. Generation (`generate`): GPT-2 small generate() in bf16, greedy, at
   bench.py:308's shape (batch 8, prompt 128, 128 new tokens): new
   tokens/s and ms per token on a synchronised host clock. Then f32
   greedy at 2x32 with 16 new tokens against argmax over a full
   re-forward (through the causal kernel) at every step.
11. Serving (`serving`): the bf16 ServingEngine at SERVE_CONFIG; warmup()
   captures one CUDA graph per bucket; each graph's replay is held
   against the same program run eagerly on the same inputs and pools
   (`graph_vs_eager`: tokens and pools equal). Then 48 requests from
   numpy seed 0 (prompts 8-128 tokens, 16-128 new), submitted in waves
   of 8 every 4 engine steps: generated tokens/s, TTFT p50/p99, dispatch
   ms p50 and sums, graphs captured, programs against
   expected_executables, sentinel events, eager dispatches after
   warm-up (0 on the card), pages free at the end (n_blocks - 1) and
   the cache invariants. The largest decode graph's replay is timed
   with CUDA events and profiled by kernel (`serving_profile`).
12. Serving parity (`serving_parity`): the f32 engine (dtype=None) under
   staggered admission, 6 requests; each stream must equal the port's
   solo greedy generate(), or differ first where that stream's top-2
   logit gap is below NEAR_TIE relative (printed per stream).
13. Serving levers (`serving_levers`, one line a lever, GPT-2 small from
   seed 0). Every lever engine is warmed, its graphs (the draft's and
   the page copy included) held bit-equal to eager (`graph_vs_eager`),
   and after each trace must show graphs = programs = expected, no
   sentinel event, no eager dispatch and every page back. int8:
   int8_gemm's int32 accumulators at every GPT-2 block matmul and
   INT8_ROWS rows against a float64 product (exact: |acc| <= 128 * 128
   * 3072 < 2**53), the output against the plain rescale, timed beside
   a bf16 matmul (`int8_matmul` lines) and with row-major codes
   (`int8_layout`); the logits-drift receipt on 4x32 prompts; the
   bf16+int8 engine over the serving trace, with its token agreement
   with the bf16 engine's streams. Speculative, k LEVER_K, DRAFT: the
   f32 streams of the parity requests against solo generate (near-tie
   rule), then the bf16 trace with that draft and with the target as
   its own draft (acceptance at least 0.5, printed). Prefix sharing:
   f32 streams of 6 staggered requests sharing a 64-token prefix
   against the unshared f32 engine's, then loadgen's shared-prefix
   traffic (SHARED_* below) through the sharing and the unshared bf16
   engines: prefix hits > 0 and a lower peak of live pages. Sampling
   (SAMPLING): two engines from one seed give equal streams over the
   trace, and the sampled prefill, decode and chunk graphs are
   bit-equal to eager on the same Gumbel noise.
14. GPT training kernels (`gpt_train_kernel`, `mask_probe` causal): the
   forward, dQ and dK/dV kernels at GPT-2 small's training shape (b 8,
   s 1024, n 12, h 64, causal, dropout 0.1, strided qkv views) against
   their plain versions in bf16 and f32 (the tolerances of 4), timed
   beside SDPA's causal forward and backward at the same p, with their
   bounds and the forward's Philox floor; the mask probe at that shape,
   causal (each row's links weigh 1/(i + 1), so dO is scaled per row to
   keep every backward link at one weight).
15. GPT training (`gpt_train_path`): GPT-2 small (GPT_TRAIN, dropout
   0.1) + AdamW(1e-4, weight decay 0.01) + TrainStep(O1, bf16) with
   lm_loss at 8x1024, ids and labels from numpy seed 0, 2 warm-up and
   10 timed steps: every step launches each kernel 12 times, losses
   finite and falling, MFU (bench.py's formula, not halved for the
   causal mask) in (0, 1); step ms, tokens/s, peak memory.
16. Chunked CE (`chunked_ce_check`, `chunked_ce`): linear_cross_entropy
   against a dense CE over materialised f32 logits (CE_CHECK: loss, dh,
   dW, db within 1e-4 x max(1, max|ref|)); then ERNIE-base 48x512 and
   GPT-2 small 8x1024 with chunked_ce=True from the dense steps' weights
   and batches: step-1 and step-2 losses within CE_LOSS_RTOL of the
   dense ones, peak memory below the dense peak (both above what each
   phase found allocated), step ms beside the dense step's.
17. Scanned stacks (`scan_layers`): ERNIE-base and GPT-2 small with
   scan_layers=True, loaded from their unrolled twins through
   load_from_layers: every step's loss equal to the unrolled run's at
   that step within SCAN_RTOL, 12 launches of each kernel a step, step
   ms beside the unrolled step's.

18. ERNIE determinism (`ernie_determinism`): ERNIE-base's eager O1
   step twice from one state and one step seed: the parameters whose
   gradients differ, the ops torch names under
   use_deterministic_algorithms(True, warn_only=True), and whether that
   mode makes the step bit-reproducible. The run fails unless the step
   is bit-reproducible (F.embedding's backward runs in that mode: the
   position and token-type gradients differed between runs before), so
   ERNIE's captured and remat checks below are bit-equal too.
19. Captured training (`captured_train`, ERNIE-base 48x512 and GPT-2
   small 8x1024, O1 bf16, dropout 0.1, AdamW): from one start state
   (TrainStep.state_dict, restored in place) and the step seeds
   STEP_SEEDS, the first call (warm-up and capture) and 3 replays
   against 4 eager steps (TrainStep.eager_step): losses and every
   parameter bit-equal; one replay repeated with the same step seed
   gives the same loss, another seed another; then 12 timed replays: 1
   graph, 0 sentinel events, host step ms beside the device ms of a
   replay (two replays under torch.profiler, which also counts 12
   launches of each kernel in each), the idle share, tokens/s, MFU,
   peak memory and the eager body's step ms from the same weights.
   Then `captured_train_scaler`: GPT-2 small with a GradScaler (scale
   2^15, dynamic) and grad_accum_steps=2 (the microbatch loop unrolled
   in the graph, 24 launches of each kernel a step), the first call and
   3 replays against 4 eager steps from one state and seed sequence;
   before the third the scale is set to inf in place, so that step's
   gradients are non-finite and the skip select runs inside the graph
   (and back to 2^15 before the fourth). Losses, the
   loss-scale state after every step and the final parameters
   bit-equal; the overflowing replay leaves the parameters as they
   were and counts one skip.
20. Captured eval (`captured_eval`): build_eval_fn on GPT-2 small (f32
   weights, 8x1024), its graph replayed twice, bit-equal to the eager
   eval forward.
21. Remat (`remat`, GPT-2 small, then ERNIE-base): the plain captured
   step and remat with policy None, "nothing_saveable" and
   "checkpoint_dots", each from the same weights and fresh AdamW state
   at the first two step seeds: step-1 and step-2 losses bit-equal to
   the plain step's, the forward launched twice per layer (its
   recompute; counted by the wrappers in the warm-up and by
   torch.profiler in two replays), step ms, device ms and peak memory
   beside the plain step's.
22. LR schedule (`lr_schedule`): a captured GPT-2 small step under
   LinearWarmup; the lr each replay reads from its buffer equals the
   scheduler's get_lr() at that step, and the parameters after 5 steps
   are bit-equal to the eager body's under the same schedule.
23. Optimizers (`optimizers`): each of the ten optimizers'
   apply_gradients captured (after a warm-up step) against the same 4
   updates run eagerly on GPT-2-width tensors, f32 and bf16 with
   multi_precision: params and state bit-equal. Then `capture_hazards`
   sums up what the captures above showed.

24. Captured generate (`generate_capture`): GPT-2 small generate() at
   GEN_CAPTURE_SHAPE in each of GEN_MODES (greedy; temperature 0.8 with top-k
   50, top-p 0.9, both; ragged prompt lengths; beam 4 with an eos), bf16
   and f32. The first call of a signature captures its programs
   (prefill, decode step, finish); a second call replays them and must
   be bit-equal to the eager loop (eager=True) from the same seed,
   capture nothing new, fire no sentinel event, and leave one program
   per signature seen. Captured and eager ms a token from the same call;
   in bf16, torch.profiler's device ms of a whole captured call and of
   its prefill and finish graphs give the device ms of one decode step
   and its kernels, and the call's idle share (1 - device ms / host
   ms). Then captured f32 greedy at GEN_CHECK against argmax over full
   re-forwards (near-tie rule of 12); the generate phase (10) and the
   parity phase (12) run the eager loop, as before.
25. Telemetry (`telemetry`): the `serving` trace through a fresh bf16
   engine four times, the planes off, on, off, on (metrics, reqtrace and
   the flight recorder armed together): the streams equal in every run,
   and in the last `serving.retired_total` and the `serving.ttft_ms`
   count equal to the requests, `serving.tokens_total` to the emitted
   tokens less each request's first (the JAX engine's definition:
   admitted_total counts those), every request with its admission,
   prefill and decode spans, explain_tail naming a component, and the
   pulse server (127.0.0.1, port 0) answering /metrics with the same
   counters; tokens/s each way. The OOM sentry on a real
   torch.cuda.OutOfMemoryError (an allocation of the card's whole
   memory inside the engine's wrapped dispatch): it propagates,
   `memory.oom_total` is 1 and the receipt's free bytes are within 5%
   of mem_get_info's. A captured GPT-2 small TrainStep with the flight
   recorder armed leaves one step.begin/step.end pair per call.
26. Fleet (`fleet`, after `telemetry`): GPT-2 small's ServingFleet at
   FLEET_CONFIG (SERVE_CONFIG's ladder plus a 256 prefill bucket, which
   requeue needs). f32, 2 replicas, the PARITY_SPECS trace admitted as
   `serving_parity` admits it, with a chaos kill and then a chaos stall
   of replica 1 at fleet tick FLEET_FAULT_TICK: every request finishes,
   at least one is requeued, the streams agree with solo generate's
   (streams_agree's near-tie rule: decode and the requeued prefill sum
   in different orders on the card), and after the eviction the card's
   allocated bytes are within 64 MiB of their level before replica 1's
   spawn. A hot swap from a second weight set written by
   distributed.checkpoint.save_sharded: one replica flips per tick, no
   capture, no sentinel event, then the streams agree with a solo f32
   engine's on the new weights; a corrupt_swap drill aborts the next
   swap with a receipt and leaves the weights in service as they were.
   bf16 overload: the serve_trace requests as one burst (every other one
   in the batch class) from 1 replica (up to 2) at queue_high
   FLEET_QUEUE_HIGH, shed depth FLEET_SHED_DEPTH and no TTFT trigger:
   scale_up spawns a replica whose graphs (and captures counted by
   sentinel.count_capture) equal its expected count, every request
   finishes or is returned shed, none dropped or evicted, idle ticks
   scale down and retire the spawned replica, and memory comes back as
   above. Tokens/s and TTFT p50/p99 beside `serving`'s, each replica's
   graphs and spawn seconds.
27. Load generator (`loadgen`, after `fleet`): paddle_tpu_torch/serving/
   loadgen.py's open-loop replays of synthetic_trace(40, 50304, seed 0,
   60 requests/s) (tools/serving_bench.py's defaults): replay_continuous
   through a bf16 engine at SERVE_CONFIG (0 recompile events, programs
   = expected), replay_static at batch 4 through generate (bf16), cold
   then warm (compiled_signatures, and the programs each leg captured),
   and replay_fleet over 2 bf16 replicas at FLEET_CONFIG on the same
   trace with a class mix of half interactive, half batch (0 dropped). Every finished
   request has exactly its max_new_tokens. Tokens/s, TTFT p50/p99 and
   per-token ms of each leg, the fleet's shed and summary().
28. Data-parallel training (`dp_train`, after the captured phases): a
   process group of one rank on NCCL (init_parallel_env in this process,
   destroyed after), GPT-2 small 8x1024 O1 (GPT_TRAIN) through
   TrainStep(mesh={"dp": 1}) from captured_train's weights, batch and
   step seeds: 1 graph, 0 sentinel events; the first call and 3 replays
   bit-equal, losses and every parameter, to the same step without a
   mesh; a replay's profile holds NCCL's all-reduce kernel once a
   gradient and once for the loss (`nccl_launches`) and 12 launches of
   each flash kernel. Then the same step with the comm planner's sync
   (make_comm_sync_transform, compress "bf16" and "int8_ef") as its
   grad_transform: step ms beside the plain dp step's, the losses after
   3 steps beside the plain ones, comm.wire_bytes of a step. Last, every
   collective of distributed/collective.py on card tensors through NCCL
   at world size 1, against the identity.
29. Elastic training (`elastic_train`, last): GPT-2 small (GPT_TRAIN, O1
   bf16, AdamW) at GPT_TRAIN_BATCH, ELASTIC_STEPS steps with an async
   save every ELASTIC_EVERY, through `python -m
   paddle_tpu_torch.distributed.launch --elastic` and
   paddle_tpu_torch/distributed/elastic_worker.py, checkpoints in a
   temporary directory: a control run, a run with chaos `kill` at step
   5 and one with `corrupt_ckpt` at step 6, side by side on the card
   (each its own launcher, worker and directory). Each chaos run leaves one
   respawn receipt with verdict crash, resumes from the newest intact
   checkpoint (printed), and its losses after the resume and its final
   checkpoint's manifest crc32s (params, moments, seed stream, step
   count) equal the control run's; every incarnation holds 1 graph, 0
   sentinel events and 12 launches of each kernel at warm-up. Printed:
   checkpoint bytes, each save's blocking ms (and the part spent joining
   the previous write) beside its background write ms, restore ms,
   seconds from the kill to the first resumed step, and the goodput
   checkpoint fraction of every incarnation.

30. Pipeline training (`pipeline_train`, after `sp_train`, outside the
   one-rank group, before `elastic_train`): ERNIE-base 48x512 split by
   ernie_pipeline_stages into 4 stages (3+3+3+3 blocks) and driven by
   PipelineParallel(num_micro=8, schedule="1f1b") (microbatches of
   6x512), AdamW, O1 bf16 under amp.auto_cast, dropout 0.1, from
   captured_train's ERNIE weights (the decoder untied: the word
   embeddings transposed). The captured engine (one CUDA graph per
   stage, op kind and signature) bit-equal to the eager engine over 3
   seeded steps (losses, every parameter); then 2 warm-up and 10 timed
   steps: 168 forward, 96 dQ and 96 dK/dV launches a step counted on
   the card (the forward in F, and again in the 3 non-last stages' B),
   every forward on the bf16 route (fwd_wgmma), the eager step's
   wrappers counting the same, 60 dispatches, 15 graphs, 0 sentinel
   events, held inputs [4, 3, 2, 1] (min(M, S - s)), the bubble
   fraction 3/11, step ms, device ms, idle share, tokens/s, MFU (PERF.md
   §2's formula over ErnieForPretraining's parameters, the recompute
   not counted) and peak memory beside captured_train's ERNIE step. At
   dropout 0 in f32: the engine's 3 losses against the captured
   TrainStep of ErnieForPretraining with its decoder untied
   (PIPE_F32_RTOL: the same function, reduced in another order); the
   interleaved engine (2 virtual stages on each of 4 ranks, 8 stages)
   against the 1F1B one, with both step ms. Before it (`pipe_kernel`,
   `mask_probe` at b 6): the three kernels at the microbatch's shape (b
   6, s 512, bf16, non-causal, p 0.1) against their plain versions.

31. ResNet-50 training (`resnet_train`, after `pipeline_train`, before
   `elastic_train`): bench.py's bench_resnet, resnet50(num_classes=1000)
   + Momentum(0.1, momentum 0.9, weight_decay 1e-4) + TrainStep(O1 bf16)
   at batch 64 x 3x224x224, inputs and labels in [0, 10) from numpy seed
   0, random weights from SEED. From one start state the first call and
   2 replays against 3 eager steps: losses, every parameter and every
   BatchNorm running statistic bit-equal (the convolutions run under
   torch's deterministic-algorithms flag, nn/functional/conv.py). Then
   2 warm-up and 12 timed replays: images/s, host step ms beside the
   device ms of a replay (torch.profiler, with the `convolutions
   (cuDNN)` and `batch norm` categories), the idle share, kernel
   launches a replay, MFU = 3 x 2 x multiply-adds (every convolution and
   the fc, counted from the model's shapes by forward hooks, near the
   4.1 G an image usually cited) x batch / step s / 989e12, peak
   memory, 1 graph and 0 sentinel events; the same replays once with
   the deterministic flag off (a second capture), to price it; the
   captured eval forward (build_eval_fn) at the batch with the trained
   running statistics. Last, resnet18(num_classes=10) at 4x3x32x32 f32,
   3 steps captured on the card against the CPU, each from the CPU
   step's state: losses, parameters and running statistics within 1e-3.
   The path launches none of the flash-attention kernels.

32. Greedy NMS kernel (`nms_kernel`, in the kernel phases): csrc/nms.cu
   (ops/nms.py greedy_nms_mask) against its plain version
   (greedy_nms_mask_plain, the same loop in torch ops) on 640 problems
   (YOLOv3's serving shape: 8 images x 80 classes) of K 400 and 1000
   sorted candidates, pixel (normalized False) and unit boxes, threshold
   0.45 with eta 1.0 and 0.7 with eta 0.9 (the decay applies above 0.5),
   from numpy seed 0: the keep masks bit-equal, kernel ms
   beside plain ms and the bound (the larger of the IoUs the valid
   candidates need over the FP32 peak and the boxes', scores' and
   mask's bytes over HBM's rate).

33. YOLOv3 training (`yolo_train`, after `resnet_train`): BASELINE config
   4, models.YOLOv3() at its defaults (80 classes, width 16, the COCO
   anchors, ignore_thresh 0.7) + Adam(1e-3) + TrainStep(O1 bf16), batch
   8, two size buckets 320 and 608 (the ends of PaddleDetection's
   YOLOv3 multi-scale list), 50 gt slots an image (num_max_boxes) with
   1-20 valid boxes drawn as examples/train_yolo.py's synth_batch draws
   them, numpy seed 0. At each size, from one start state, the first
   call and 2 replays against 3 eager steps: losses, every parameter and
   every running statistic bit-equal. Then 6 steps at alternating
   sizes: exactly 2 graphs and 0 sentinel events (the sentinel told
   to expect one program a bucket). At each size, 2 warm-up and 12
   timed replays: step ms, images/s, device ms and the idle share
   (torch.profiler over 2 replays), kernel launches a replay, device
   time by category, MFU = 3 x 2 x multiply-adds (every convolution,
   counted from the model's shapes) x batch / step s / 989e12, peak
   memory. 0 flash-attention launches. Last, width 4 at 2x3x64x64 f32,
   3 Adam steps captured on the card against the CPU, each from the
   CPU's state: losses, parameters and running statistics within 1e-3.

34. hapi.Model.fit (`yolo_fit`): a fresh YOLOv3() through hapi.Model with
   InputSpecs (img; gt_box, gt_label), prepare(Adam, loss,
   amp_configs="O1"), one epoch of fit and one of evaluate over 64
   synthetic images whose sizes are drawn from {320, 352, ..., 608}
   (half at 320, the rest uniform over the others: a uniform draw would
   leave the 320 bucket without a full batch), made in the loader's 2
   thread workers; a collate pads each image to the smallest bucket of
   (320, 608) that holds it and rescales its normalised boxes to the
   padded canvas; BucketBatchSampler(boundaries=(320, 608), batch size
   8, drop_last) batches them. The TrainStep holds 2 graphs, every loss
   is finite; fit's images/s (host clock, the batches after both
   captures) beside yolo_train's shows the loop's host cost (its
   per-step .item()).

35. YOLOv3 serving (`yolo_serve`): yolo_train's model in eval mode,
   batch 8 at 608x608: ms a batch of the forward, decode (yolo_box over
   the three heads), predict "hard" (multiclass_nms: per-class top-k,
   the greedy kernel, the keep_top_k pack) and "matrix" (matrix_nms),
   split by part. The hard path launches the NMS kernel once a predict
   (counted from 0 around one predict); on its own sorted candidates
   the kernel's keep mask, and multiclass_nms's rows, counts and
   indices, are bit-equal to the plain version's.

36. The op library on the card (`ops_card`, after `yolo_serve`): every
   case of tests/torch_ops_cases.py (the parity table that
   tests/test_torch_ops_*.py hold against the JAX package on the CPU:
   creation, math, manipulation, logic, search, stat and the in-place
   forms) run by the port on the card and on the CPU, the outputs and
   the gradients of sum(out * w) compared at the table's tolerances
   (f32 elementwise 1e-6 x max(1, |ref|), reductions 1e-5, integers and
   bools exact); every tensor output must be on the card, the creation
   ops' included (the current place is the card). Each random op draws
   on the card, in the shape asked for, and paddle.seed reproduces it.
   The worst error over its limit is printed per tolerance class.

37. BASELINE config 1 (`mnist_dygraph`): LeNet at its own widths on
   vision.datasets.MNIST at MNIST's sizes (60000 train and 10000 test
   synthetic 1x28x28 images, transforms.Normalize(127.5, 127.5)),
   batch 64, optimizer.Adam(1e-3), random weights from SEED. The eager
   loop as Paddle users write it (io.DataLoader, paddle.reshape,
   F.cross_entropy, paddle.mean, backward, step, clear_grad) for one
   epoch, its first 20 losses against the same 20 steps on the CPU from
   the same weights and batches (MNIST_PARITY_RTOL, TF32 off); the test
   accuracy under no_grad (paddle.argmax, and paddle.metric.accuracy
   batch by batch) must beat tests/test_models_hapi.py:108's bar (0.5);
   paddle.save/paddle.load of the state dict must give a model whose
   outputs are bit-equal. Then hapi.Model(LeNet()).fit(train, epochs=1,
   batch_size=64) (the captured TrainStep: 2 graphs, the last batch
   holding 32 images) and evaluate, over the same bar. Recorded beside
   the card's name and power limit: images/s of the eager epoch and of
   fit (host clock, data loading included), and one eager step's device
   time by category (device_profile over 20 steps at a fixed batch)
   beside its step time, the idle share. The path launches none of the
   port's own kernels (counted from 0 across the phase).

38. Transformer-base (`transformer_train`, after `mnist_dygraph`): the
   base model of Vaswani et al. (2017) as their WMT'14 En-De run trains
   it, written as user code against paddle.nn (`mt_model`):
   nn.Transformer() at its defaults (d_model 512, 8 heads, 6 + 6
   layers, FFN 2048, dropout 0.1, ReLU, post-norm), one Embedding(37000,
   512) shared by source and target and scaled by sqrt(512), a fixed
   sinusoid table, the output projection tied to the embedding
   (paddle.matmul(h, emb.weight, transpose_y=True)), 63.1 M parameters;
   nn.CrossEntropyLoss(soft_label=True) over F.label_smooth(F.one_hot(
   label, 37000), 0.1); Adam(0.9, 0.98, 1e-9) under NoamDecay(512,
   4000); TrainStep O1 bf16, batch 32 of 128 source and 96 target
   synthetic token ids (one length bucket, no padding). Each encoder
   self-attention and each cross-attention (sq 96, sk 128) takes
   F.flash_attention, with in-kernel dropout; each causal decoder
   self-attention takes SDPA, as in the JAX package. From one start
   state, the first call and 3 replays against 4 eager steps at
   STEP_SEEDS: losses and every parameter bit-equal; an eager step's
   routes counted at nn.functional (12 flash_attention calls, 6 SDPA
   calls); a replay's kernels counted on the card by torch.profiler, at
   least 12 of each of the three (so the plain versions never stand
   in). Then 2 warm-up and 10 timed replays (the scheduler stepped):
   step ms beside the device ms, the idle share, source and target
   tokens/s, MFU from mt_train_flops (2 x 3 x the multiply-adds counted
   from the shapes), peak memory, device time by category. Card against
   CPU: the same function at the CPU tests' tiny size (MT_TINY: d_model
   32, 4 heads of 8, which the kernels run zero-padded to 64, 2 + 2
   layers, FFN 64), vocab 97, batch 3 of 12 and 9 tokens, f32, dropout
   0, weights from SEED, 4 TrainStep steps each (captured on the card):
   losses within 1e-3 relative.
39. LSTM seq2seq (`rnn_seq2seq`): an LSTM encoder-decoder at the
   widths of PaddleNLP's machine_translation/seq2seq example on
   IWSLT'15 En-Vi (vocabularies 17,191 and 7,709, 512 wide, 2 layers,
   dropout 0.2; its attention, user code outside paddle.nn, left out),
   user code against paddle.nn (`seq2seq_model`): nn.LSTM encoder, an
   nn.LSTMCell decoder run by nn.RNN (teacher forcing) from the top
   encoder layer's final state, nn.Linear output. 3 eager steps at batch
   64 of 50 and 50 synthetic tokens, nn.CrossEntropyLoss, Adam(1e-3)
   with ClipGradByGlobalNorm(5.0): ms a step, losses finite; at dropout
   0 from the same weights, 3 steps on the card and on the CPU: losses
   within 1e-3. dynamic_decode(BeamSearchDecoder(cell, 1, 2, beam 10,
   the target embedding, the output Linear), max_step_num=50) of the 64
   sentences on the card and on the CPU from the card's trained
   weights: ms a decoded batch and a step, the steps taken (early exit
   once every beam has finished), scores within 1e-3 relative, best
   beams' ids equal wherever the best-beam lead exceeds 10 times the
   largest card-CPU score gap in nats (the near-ties counted, and the
   sentences whose best beams are equal), and every beam's ids of every
   sentence re-scored on the CPU by teacher forcing to within 10 times
   that gap plus the re-scoring's own, of the score the card gave it
   (ids that are not the sequence their score belongs to fail).
   The path launches none of the port's own kernels.
40. Head_dim 256 (`d256_case`, `d256_routes`, `mask_probe` at h 256,
   `encoder_256`, `encoder_256_f32`, after `head_pad`): in bf16
   csrc/flash_attn_wg256.cu's wgmma forward, dQ (computing delta) and
   dK/dV, in f32 csrc/flash_attn_wide.cu's FFMA forward, dQ (computing
   delta) and dK/dV, each a cluster of one CTA, at b 8, s 1024, n 8, h
   256, strided qkv views, f32 and bf16, p 0 and 0.1, causal and not,
   and at encoder_256's attention (b 8, s 1024, n 16, p 0.1, separate
   q, k and v) in both dtypes, each held row by row against the plain
   versions at TOL (the forward too, and the dQ kernel's own delta) and
   timed beside the bound and SDPA; `d256_routes`: the kernels a
   forward and backward runs in each dtype, by name, counted by
   torch.profiler; the mask probes at D256_SHAPE; `head_pad` runs
   head_dims 192 and 256 through flash_attention_fwd (192 padded to
   256); ptxas must report the 12 instantiations of the wgmma file with
   no spill. `encoder_256`: nn.TransformerEncoderLayer(4096, 16, 16384)
   (head_dim 256), 8 x 1024 tokens, O1 bf16, dropout 0.1, AdamW, one
   captured TrainStep step and one replay bit-equal to two eager steps;
   a replay's attention kernels counted by torch.profiler (the three
   wgmma kernels, once each); step ms, device ms by category and
   attention's share of it. `encoder_256_f32`: the same step in f32
   with no AMP, holding the three FFMA kernels at 256 once each.
41. AMP on the card (`amp_card`, after `ops_card`): each op the JAX
   package registers under a name on its AMP lists (AMP_OPS) under
   auto_cast O1 and O2 from bf16 and f32 inputs: the lists' output
   dtype. `ops_card` runs the op library's second half too (linalg,
   einsum, sequence, misc, loss_extra, extras, amp_ops; a dotted case
   name is a path below the top level).
42. CoNLL-2005 SRL (`srl_train`, after `rnn_seq2seq`): the book's
   db-LSTM + linear-chain CRF at its widths (SRL) on the synthetic
   paddle.text.Conll05st: one epoch (51 batches of 10 sentences of 30
   tokens) through the captured TrainStep in f32 and the same steps
   eagerly from the same weights, losses and parameters bit-equal; the
   first 4 losses card against CPU within 1e-4; ms a step captured and
   eager, tokens/s, device ms by category and the idle share; the 64
   test sentences Viterbi-decoded on the card (ms a batch of 10, token
   accuracy), every path re-scored on the CPU in float64 within 1e-4 of
   its Viterbi score, and equal to the CPU's decode wherever the CPU's
   top-two margin exceeds 10 times the card-CPU score gap; the mean of
   the last 10 losses below the first 10's. No kernel of the port runs
   on this path.
43. Head_dim above 256 (`wide_case`, `mask_probe` at h 512 and 1024,
   `wide_hard_case`, `wide_routes`, `sdpa_f32_routes`, `encoder_wide`,
   `encoder_wide_f32`, after `d256_case`): the bf16 forward, dQ and
   dK/dV on csrc/flash_attn_wgwide.cu's wgmma kernels, the f32 ones on
   csrc/flash_attn_wide.cu's FFMA kernels (each a cluster of chunk CTAs
   per row block), at WIDE_SHAPE (b 2, s 512, n 4) against
   their plain versions, row by row at TOL, f32 and bf16, p 0 and 0.1,
   causal and not: at h 512 and 1024 on the kernels' entries
   (bwd_kernel_case, the dQ kernel's own delta held too; each kernel
   also timed alone on the card, wide_device_ms), at 320 through the
   autograd entry (padded to 512; pad_case), and at encoder_wide's
   attention (b 8, s 1024, n 8, h 512, p 0.1, separate q, k and v) in
   both dtypes; at WIDE_HARD_CASES in both dtypes (causal
   cross-attention both ways, s 200, one head, D 768) and in f32 at D
   2304 (nine chunks, two a CTA); each case launches every kernel, and a
   forward and backward at D 768 runs WIDE_ROUTES' kernels by name;
   ptxas reports no spill in the 20 FFMA and 12 wgmma instantiations
   and no serialisation in the 12. `sdpa_f32_routes`: the kernels SDPA's
   f32 forward and backward run at h 512 and 1024, by name.
   `encoder_wide`: encoder_256's step at nn.TransformerEncoderLayer(4096,
   8, 16384) (head_dim 512), its replay holding the three wgmma kernels
   above 256 once each; `encoder_wide_f32`: the same step in f32 with no
   AMP, holding the three FFMA kernels above 256 once each.
44. Captured while_loop (`graph_while`, after the head_dim cases):
   ops.control_flow.while_loop inside static/capture.py's capture, a
   conditional WHILE node (csrc/graph_while.cu): Collatz steps of 4
   lanes, replayed with COLLATZ_INPUTS (trip counts 118, 178, 0, 350),
   every replay equal to the eager loop; one graph, no sentinel event;
   a replay's ms against the eager loop's.
45. Anatomy and the sentry (`anatomy`, then `sentry_train`, after
   `optimizers`): captured_train's ERNIE-base step without the sentry
   (its FLOPs, device ms and bytes by scope; ThroughputMeter's MFU; the
   calibration probes on the card and the audit of the step), then with
   TrainStep(sentry=NumericSentry(...)): bit-equal parameters, the
   statistics and fingerprints against their host twins, the sentry's
   cost, a poisoned step flagged, and card against CPU (see
   anatomy_phase and sentry_train_phase).
46. Optimizer extras (`optimizer_extras`, after `sentry_train`): EMA,
   ModelAverage and Lookahead over ERNIE-base's parameters after
   captured steps against a CPU recomputation.
   `elastic_train` (29) gains the numeric case: the worker's --sentry
   and a NaN gradient at step 5, exit 13, a NUMERIC verdict and the
   resume from the newest health-stamped checkpoint.

Output: a JSON line per phase; then the
`kernels` line (each flash kernel with its launches a Transformer-base
step and its times at the cross-attention and encoder self-attention
shapes, its head_dim-256 cases and those above 256; the kernels of the
encoder paths at head_dim 256 and 512 (three wgmma kernels each in
bf16, three FFMA kernels each in f32), with each path's launches and
their times at its attention shape; the
captured loop's set_condition kernel; the run's phase_seconds), the card's
nvidia-smi line, and last {"ok": true,
"device": {...}}. Without CUDA, or when the repo's paddle_tpu_torch
package is not beside this file, it exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import functools

REPO = os.path.dirname(os.path.abspath(__file__))

BASE = dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=512)
BATCHES = [(32, 512), (32, 128), (8, 384), (16, 200)]
CPU_BATCH = (2, 128)
SEED = 0
TRAIN_BATCH = (48, 512)   # bench.py:70's base batch x seq
# ERNIE-base-MoE (examples/train_ernie_moe_longctx.py's expert count and
# top-k; ErnieConfig's defaults for the rest: every 2nd layer, capacity
# 1.25, aux weight 0.01) at bench.py's batch
MOE = dict(moe_num_experts=4, moe_top_k=2)
MOE_BATCH = TRAIN_BATCH
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
DROP_P, DROP_SEED = 0.1, 1234

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# FLOP/s by input type (f32 on the FP32 pipes, bf16 on the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# attention outputs are held row by row (_row_err_ok); a bf16 row's
# tolerance is TOL of its own max|ref|, or of this share of the whole
# tensor's max|ref| where the row is smaller
ROW_FLOOR = 1e-3
# kernels whose ptxas report must show no spill at head_dim 64
NO_SPILL = ("fwd_wgmma", "dq_wgmma", "dkv_wgmma")
# the f32 FFMA kernels at 64 and 128 by source: csrc/flash_attn_fwd.cu's
# fwd_ffma and csrc/flash_attn_bwd.cu's dq_ffma and dkv_ffma, each x
# head_dim x causal x dropout, none spilling
FFMA_GATES = {"flash_attn_fwd": (("fwd_ffma",), 2 * 2 * 2),
              "flash_attn_bwd": (("dq_ffma", "dkv_ffma"), 2 * 2 * 2 * 2)}
# integer instructions an SM issues per clock (CUDA C++ Programming
# Guide, arithmetic-instruction throughput, compute capability 9.0:
# 32-bit integer add, multiply-add, shift, compare and logic ops)
INT_OPS_PER_CLOCK_SM = 64
# Philox4x32-10's two round multipliers, as ptxas prints them
PHILOX_MULS = ("0xd2511f53", "-0x2daee0ad", "0xcd9e8d57", "-0x326172a9")

# GPT-2 small as bench.py:306 defines it (dropout 0: eval)
GPT2 = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
            max_seq_len=1024, dropout=0.0)
GPT_BATCHES = [(8, 1024), (8, 128)]
# GPT-2 small in training: GPTConfig's default dropout 0.1 (attention
# dropout in the three kernels, causal), 8 sequences of the full 1024
# context, the gpt_forward phase's 8x1024
GPT_TRAIN = dict(GPT2, dropout=0.1)
GPT_TRAIN_BATCH = (8, 1024)
# the chunked-CE and scanned variants: warm-up and timed steps
VARIANT_WARMUP, VARIANT_STEPS = 2, 5
# linear_cross_entropy against a dense CE over materialised f32 logits:
# ERNIE-base's head width and vocab, 4096 rows, the default vocab block
CE_CHECK = dict(n=4096, d=768, vocab=30528, block=2048)
# step-1 and step-2 losses of a chunked (f32 head) run against the dense
# run's (bf16 logits under O1), relative: a head that dropped its partial
# last vocab block would move GPT's by about 2e-3; every loss of a scanned
# run against the unrolled one's at the same step
CE_LOSS_RTOL, SCAN_RTOL = 1e-4, 1e-5
GEN_SHAPE = (8, 128, 128)       # bench.py:308: batch, prompt, new tokens
# generate_capture's rows: GEN_SHAPE at half its new tokens (each row runs
# the eager loop once or twice and profiles a whole captured call)
GEN_CAPTURE_SHAPE = (8, 128, 64)
GEN_CHECK = (2, 32, 16)         # f32 greedy against full re-forwards
SERVE_CONFIG = dict(max_slots=16, max_admit=4, block_size=16, n_blocks=257,
                    prefill_buckets=(32, 64, 128), decode_buckets=(4, 8, 16),
                    decode_chunk=4, max_total_tokens=256)
SERVE_REQUESTS, SERVE_WAVE, SERVE_EVERY = 48, 8, 4
# f32 parity trace: (prompt length, new tokens), submitted staggered
PARITY_SPECS = [(40, 24), (17, 20), (100, 16), (9, 30), (64, 12), (128, 20)]
NEAR_TIE = 1e-4
# -- the serving levers ---------------------------------------------------------
# int8: GPT-2 small's block matmuls (in, out) at these row counts
INT8_ROWS = (4, 16, 128)
INT8_DRIFT = (4, 32)            # prompts x tokens of the logits-drift receipt
LEVER_K = 4                     # speculative proposals per boundary
# tools/serving_bench.py:93 build_draft at GPT-2 small's widths: the same
# vocab, half the hidden width and heads, 1 layer (--draft-layers)
DRAFT = dict(GPT2, hidden_size=384, num_heads=6, num_layers=1)
# paddle_tpu/serving/loadgen.py:47's shared-prefix mode: one trace-wide
# prefix on serving_bench's --shared-frac default share of the requests
SHARED_PREFIX, SHARED_FRAC = 64, 0.9
SHARED_TAILS, SHARED_NEW = (8, 64), (16, 128)
# f32 shared-prefix parity: (tail length, new tokens), staggered
SHARED_PARITY = [(8, 24), (17, 20), (40, 16), (9, 30), (64, 12), (30, 20)]
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)


def seed_card(torch):
    """DROP_SEED as the kernels read it: a 0-d int64 tensor on the card,
    made once (an eager caller's int seed becomes such a tensor at every
    call, host work a kernel's timing should not carry)."""
    global _SEED_CARD
    if _SEED_CARD is None:
        _SEED_CARD = torch.tensor(DROP_SEED, dtype=torch.int64,
                                  device="cuda")
    return _SEED_CARD


_SEED_CARD = None


def emit(obj):
    print(json.dumps(obj), flush=True)


class _PhaseClock:
    """Seconds of each stretch of the run (phase_seconds, printed with
    the kernels line) and of each phase inside it (step_seconds), for
    keeping the whole run inside its time limit; each stretch's end is
    also written to stderr with the seconds since the clock started, so
    a run that is cut shows how far it got."""

    def __init__(self):
        self.t0 = self.t = self.s = time.perf_counter()
        self.laps, self.steps = {}, {}

    def step(self, name):
        now = time.perf_counter()
        self.steps[name] = round(now - self.s, 1)
        self.s = now

    def lap(self, name):
        now = time.perf_counter()
        if now - self.s >= 0.05:
            self.step(name)
        self.s = now
        self.laps[name] = round(now - self.t, 1)
        self.t = now
        print(f"chip_smoke: {name} took {self.laps[name]} s, "
              f"{round(now - self.t0, 1)} s in all", file=sys.stderr,
              flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_spills(log):
    """[(function, spill store bytes, spill load bytes)] from nvcc's
    -Xptxas -v output."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("Function properties for", 1)[1].strip()
        elif "spill stores" in ln and cur is not None:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            out.append((cur, nums[1], nums[2]))
            cur = None
    return out


def ffma_ptxas_failure(name, log):
    """What is wrong with the f32 FFMA kernels of source `name` in
    nvcc's -Xptxas -v output (FFMA_GATES: an instantiation missing, or
    one spilling), or None."""
    if name not in FFMA_GATES:
        return None
    kernels, want = FFMA_GATES[name]
    ffma = [(f, st, ld) for f, st, ld in ptxas_spills(log)
            if any(k in f for k in kernels)]
    spilling = [f for f, st, ld in ffma if st or ld]
    if len(ffma) != want or spilling:
        return (f"ptxas: {len(ffma)} f32 FFMA kernels of {name} reported "
                f"(want {want}), spilling: {spilling}")
    return None


def ptxas_serialised(log):
    """Functions whose wgmma ptxas serialises (C7515, C7512), from
    nvcc's -Xptxas -v output."""
    out = []
    for ln in log.splitlines():
        if "C7515" in ln or "C7512" in ln:
            name = ln.rsplit("function", 1)[-1].strip(" '")
            out.append(name)
    return out


def sass_functions(text):
    """{function: [(address, instruction)]} from cuobjdump -sass."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        if "Function : " in ln:
            cur = ln.split("Function : ", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None and "/*" in ln and "*/" in ln:
            head, _, rest = ln.partition("*/")
            addr = head.strip().lstrip("/*").strip()
            ins = rest.split(";")[0].strip()
            if ins and all(c in "0123456789abcdef" for c in addr):
                funcs[cur].append((int(addr, 16), ins))
    return funcs


def philox_loop(instrs):
    """(instructions per Philox4x32-10 call, calls in the loop, loop
    instructions) of the innermost loop of a kernel's SASS that draws
    keep bits: the smallest span [target, branch] of a backward branch
    that holds Philox's round multiplies. A call ends in four unsigned
    compares of its words with the keep threshold (ISETP.GE.U32), which
    count the calls; its 20 multiplies (an IMAD.WIDE.U32, or an
    IMAD.HI.U32 beside a low IMAD, each) check the count, less the few
    that ptxas hoists or shares between calls. None when there is no
    such loop."""
    best = None
    for addr, ins in instrs:
        words = ins.split()
        op = words[1] if words[0].startswith("@") else words[0]
        if not op.startswith("BRA") or not words[-1].startswith("0x"):
            continue
        target = int(words[-1], 16)
        if target >= addr:
            continue
        body = [x for a, x in instrs if target <= a <= addr]
        muls = sum(1 for x in body if (".WIDE" in x or ".HI" in x)
                   and any(k in x.lower() for k in PHILOX_MULS))
        calls = sum(1 for x in body if "ISETP.GE.U32" in x) // 4
        if calls and 15 * calls <= muls <= 20 * calls and (
                best is None or len(body) < best[2]):
            best = (len(body) / calls, calls, len(body))
    return best


def philox_floor_ms(calls, instr_per_call, sms, clock_mhz):
    """Least time for `calls` Philox4x32-10 calls of `instr_per_call`
    integer instructions each, at INT_OPS_PER_CLOCK_SM on every SM."""
    rate = sms * INT_OPS_PER_CLOCK_SM * clock_mhz * 1e6
    return calls * instr_per_call / rate * 1e3


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fwd_work(b, sq, sk, n, h, causal, dtype_name):
    """(bytes, flops) of one flash forward: q, k, v read once, O and lse
    written once; QK^T and PV over the links this mask keeps."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = (b * sq * n * h + 2 * b * sk * n * h + b * sq * n * h) * esize \
        + b * n * sq * 4
    return nbytes, 4.0 * b * n * h * _pairs(sq, sk, causal)


def fwd_bound(b, sq, sk, n, h, causal, dtype_name, dropout_p=0.0,
              philox=None):
    """The forward's bound with what it leaves out. bound_ms, the least
    time on an H100, is the larger of its bytes over the memory rate and
    its flops over the peak rate of the input type (fwd_work): bytes and
    tensor-core flops only. With dropout the call also draws one
    Philox4x32-10 call per 2x2 block of kept-mask links, integer work
    beside them: philox_calls, and with philox = (instructions per call,
    SMs, max SM clock MHz) from the card, its integer instructions and
    the floor they set (philox_floor_ms). At p 0 there is no such work
    (None)."""
    nbytes, flops = fwd_work(b, sq, sk, n, h, causal, dtype_name)
    ms, by = _bound(nbytes, flops, dtype_name)
    row = dict(bytes=nbytes, flops=flops, bound_ms=ms, bound_by=by,
               philox_calls=None, philox_int_instructions=None,
               philox_floor_ms=None,
               bound_note="bytes and tensor-core flops; no dropout work")
    if dropout_p:
        row["philox_calls"] = b * n * _pairs(sq, sk, causal) // 4
        row["bound_note"] = ("bytes and tensor-core flops only: leaves out "
                             "the dropout's Philox integer work "
                             "(philox_floor_ms)")
        if philox is not None:
            ipc, sms, clock_mhz = philox
            row["philox_int_instructions"] = row["philox_calls"] * ipc
            row["philox_floor_ms"] = philox_floor_ms(
                row["philox_calls"], ipc, sms, clock_mhz)
            row["bound_reachable"] = row["philox_floor_ms"] <= ms
    return row


# Transformer-base's attentions on the kernels, as MultiHeadAttention
# runs them: b 32, n 8, h 64 at (sq, sk) of MT_SHAPES (the encoder's
# self-attention at (128, 128), the decoder's cross-attention at (96,
# 128), and its mirror (128, 96)), q, k and v separate contiguous
# tensors (three Linears), f32 and bf16, dropout 0 and (bf16) the
# training path's 0.1
MT_SHAPES = ((128, 128), (96, 128), (128, 96))


def mt_cases():
    """(b, sq, n, h, causal, dtype, dropout p, sk, separate) of the
    Transformer-base kernel cases."""
    return [(32, sq, 8, 64, False, dt, p, sk, True)
            for sq, sk in MT_SHAPES for dt in ("float32", "bfloat16")
            for p in ((0.0, DROP_P) if dt == "bfloat16" else (0.0,))]


def _unpack(case):
    """(b, s, n, h, causal, dtype, p, sk, separate) of a kernel case
    (b, s, n, h, causal, dtype, p[, sk, separate]): sk defaults to s and
    separate (q, k and v separate tensors) to False (views of one
    qkv)."""
    return tuple(case) + ((case[1], False) if len(case) == 7 else ())


def _layout(separate):
    return "separate q, k, v" if separate else "qkv views"


def attention_inputs(torch, gen, b, s, sk, n, h, dtype, separate):
    """q [b, s, n, h], k and v [b, sk, n, h] from `gen`: separate
    contiguous tensors where `separate` (MultiHeadAttention's three
    projections), else strided views of one fused qkv tensor (the ERNIE
    and GPT paths' layout, which needs sk == s)."""
    if not separate and sk != s:
        raise ValueError(f"views of one qkv take as many keys as queries, "
                         f"got s {s}, sk {sk}")
    dev = torch.device("cuda", 0)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    if separate:
        return draw((b, s, n, h)), draw((b, sk, n, h)), draw((b, sk, n, h))
    qkv = draw((b, s, 3, n, h))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def kernel_phase(torch, fa):
    dev = torch.device("cuda", 0)
    sd = seed_card(torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n, h = BASE["num_attention_heads"], \
        BASE["hidden_size"] // BASE["num_attention_heads"]
    cases = [(32, s, n, h, causal, dt, 0.0)
             for dt in ("float32", "bfloat16")
             for s in (512, 200) for causal in (False, True)]
    cases += [(8, 256, 8, 128, causal, dt, p)
              for dt in ("float32", "bfloat16") for causal in (False, True)
              for p in ((0.0, DROP_P) if dt == "bfloat16" else (0.0,))]
    rows = []
    for case in cases + mt_cases():
        b, s, nh, hd, causal, dt, p, sk, sep = _unpack(case)
        q, k, v = attention_inputs(torch, gen, b, s, sk, nh, hd,
                                   getattr(torch, dt), sep)
        scale = 1.0 / math.sqrt(hd)
        o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(
            q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED)
        torch.cuda.synchronize()
        tol = TOL[dt]
        err_o, ratio, rows_ok = _row_err_ok(o, o_ref, dt)
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (rows_ok
              and torch.allclose(o.float(), o_ref.float(), atol=tol, rtol=tol)
              and torch.allclose(lse, lse_ref, atol=tol, rtol=tol))
        row = dict(dtype=dt, b=b, s=s, sk=sk, n=nh, h=hd, causal=causal,
                   dropout_p=p, layout=_layout(sep), max_abs_err=err_o,
                   worst_row=ratio, lse_max_abs_err=err_lse, tol=tol,
                   ok=bool(ok))
        if not ok:
            emit({"kernel_case": row})
            fail(f"flash_attn_fwd disagrees with its plain version: {row}")
        row["ms"] = time_ms(lambda: fa._flash_fwd_cuda(
            q, k, v, causal, scale, p, sd), reps=20)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED),
            reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale, dropout_p=p),
            reps=20)
        bound = fwd_bound(b, s, sk, nh, hd, causal, dt)
        row["bound_ms"], row["bound_by"] = bound["bound_ms"], bound["bound_by"]
        emit({"kernel_case": row})
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return rows


HOST_CALLS = 300


def host_cost_phase(torch, fa):
    """Host microseconds a call of the bf16 forward wrapper takes at
    GPT-2's 8x128 causal shape (ROADMAP item 11): HOST_CALLS calls on
    the host clock with no sync inside (the kernel runs for a few
    microseconds, so the loop is bound by the host), at p 0 (no seed),
    and at p 0.1 with an int seed (made into a card tensor by a fill
    kernel at every call) and with a seed tensor already on the card
    (as a captured step passes its slot)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    b, s = GPT_BATCHES[1]
    n = GPT2["num_heads"]
    h = GPT2["hidden_size"] // n
    qkv = torch.randn((b, s, 3, n, h), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 1.0 / math.sqrt(h)
    sd = seed_card(torch)
    cases = {"p0": (0.0, None), "p0.1_int_seed": (DROP_P, DROP_SEED),
             "p0.1_card_seed": (DROP_P, sd)}
    row = dict(b=b, s=s, n=n, h=h, dtype="bfloat16", causal=True,
               calls=HOST_CALLS)
    for name, (p, seed) in cases.items():
        def call():
            return fa._flash_fwd_cuda(q, k, v, True, scale, p, seed)
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            call()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        row[f"{name}_host_us"] = host / HOST_CALLS * 1e6
    emit({"host_cost": row})
    return row


def _pairs(sq, sk, causal):
    """(query, key) links the mask keeps."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_bound_ms(kernel, b, sq, sk, n, h, causal, dtype_name):
    """Least time on an H100 for one backward kernel: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its flops over the peak rate of the input type.
    dQ: q, k, v, dO, O, lse in, dq and delta out; 3 products (S, dP,
    dS K; the rowsum(dO*O) of delta is 2 h flops a row, not counted).
    dK/dV: the same inputs, dk and dv out; 4 products (S, dP, P^T dO,
    dS^T Q). Each product is 2 h flops per kept (query, key) link."""
    esize = 4 if dtype_name == "float32" else 2
    q_el, k_el = b * sq * n * h, b * sk * n * h
    stats = 2 * b * n * sq * 4
    if kernel == "dq":
        nbytes = (3 * q_el + 2 * k_el + q_el) * esize + stats
        products = 3
    else:
        nbytes = (2 * q_el + 2 * k_el + 2 * k_el) * esize + stats
        products = 4
    flops = products * 2.0 * b * n * h * _pairs(sq, sk, causal)
    return _bound(nbytes, flops, dtype_name)


def _err_ok(got, ref, dt):
    """(max abs error, tolerance, ok): f32 1e-4 * max(1, max|ref|),
    bf16 2e-2 * max|ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    big = ref.float().abs().max().item()
    tol = TOL[dt] * (max(1.0, big) if dt == "float32" else big)
    return err, tol, err <= tol


def _row_err_ok(got, ref, dt):
    """(max abs error, worst row ratio, ok) of an attention output
    [..., h], held row by row (a query row of O and dQ, a key row of dK
    and dV): row r's largest error over max(1, max|ref_r|) in f32 and
    over max(max|ref_r|, ROW_FLOOR * max|ref|) in bf16, at most TOL. A
    causal output's rows shrink with the keys they see (|O_i| about
    1/sqrt(i + 1)), so one tolerance from the largest row would let the
    late rows be wrong by as much as they hold; the floor keeps rows
    that cancel to about 0 (dQ of row 0) at rounding noise."""
    d = (got.float() - ref.float()).abs().amax(-1)
    r = ref.float().abs().amax(-1)
    if dt == "float32":
        scale = r.clamp(min=1.0)
    else:
        scale = r.clamp(min=ROW_FLOOR * r.max().item())
    ratio = (d / scale.clamp(min=1e-30)).max().item()
    return d.max().item(), ratio, ratio <= TOL[dt]


def _sdpa_fb(torch, q, k, v, do, causal, scale, p):
    """SDPA forward + backward and forward-only callables, [b, s, n, h]
    inputs: the library yardstick of the backward kernels."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=causal, scale=scale, dropout_p=p)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return fwd, fwd_bwd


# the f32 backward at head_dim 128 over the whole card: b, s, n, h,
# causal, dtype (at p 0 and DROP_P in bwd_kernel_phase)
F32_H128_FULL = (8, 1024, 8, 128, False, "float32")


def bwd_kernel_phase(torch, fa, philox):
    """The backward kernels and the forward against their plain versions
    at the training path's shapes. philox: (instructions per Philox
    call, SMs, max SM clock MHz) for the forward's bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    n, h = BASE["num_attention_heads"], \
        BASE["hidden_size"] // BASE["num_attention_heads"]
    b = TRAIN_BATCH[0]
    cases = [(b, s, n, h, causal, dt, 0.0)
             for dt in ("float32", "bfloat16")
             for s in (512, 200) for causal in (False, True)]
    cases += [(b, 512, n, h, False, dt, DROP_P)
              for dt in ("float32", "bfloat16")]
    cases += [(b, 200, n, h, True, "bfloat16", DROP_P)]
    # the f32 FFMA backward at 64: the rest of s 512 and 200, causal and
    # not, at DROP_P
    cases += [(b, s, n, h, causal, "float32", DROP_P)
              for s, causal in ((512, True), (200, False), (200, True))]
    cases += [(8, 256, 8, 128, causal, dt, 0.0)
              for dt in ("float32", "bfloat16") for causal in (False, True)]
    cases += [F32_H128_FULL[:6] + (p,) for p in (0.0, DROP_P)]
    return [bwd_kernel_case(torch, fa, gen, case, philox, with_fwd=True)
            for case in cases + mt_cases()]


def bwd_kernel_case(torch, fa, gen, case, philox, tag="bwd_kernel_case",
                    with_fwd=None):
    """One case (b, s, n, h, causal, dtype, dropout p[, sk, separate])
    of the backward kernels (and the forward, in bf16 and with dropout,
    or as with_fwd says) against their plain versions, with their times
    and bounds; emitted under `tag`. sk (the key length) defaults to s,
    and q, k and v to views of one qkv tensor (_unpack,
    attention_inputs)."""
    sd = seed_card(torch)
    dev = torch.device("cuda", 0)
    b_, s, nh, hd, causal, dt, p, sk, sep = _unpack(case)
    dtype = getattr(torch, dt)
    q, k, v = attention_inputs(torch, gen, b_, s, sk, nh, hd, dtype, sep)
    do = torch.randn((b_, s, nh, hd), generator=gen, device=dev,
                     dtype=torch.float32).to(dtype)
    scale = 1.0 / math.sqrt(hd)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                    p, sd)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                       scale, p, DROP_SEED)
    torch.cuda.synchronize()
    row = dict(dtype=dt, b=b_, s=s, sk=sk, n=nh, h=hd, causal=causal,
               dropout_p=p, layout=_layout(sep))
    ok = True
    row["tol"] = TOL[dt]
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err, ratio, good = _row_err_ok(got, want, dt)
        row[f"{name}_max_abs_err"], row[f"{name}_worst_row"] = err, ratio
        ok &= good
    if with_fwd is None:
        with_fwd = bool(p) or dt == "bfloat16"
    if with_fwd:
        o_ref, lse_ref = fa.flash_attention_fwd_plain(
            q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED)
        err, ratio, good = _row_err_ok(o, o_ref, dt)
        row["o_max_abs_err"], row["o_worst_row"] = err, ratio
        row["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
        ok &= good and row["lse_max_abs_err"] <= TOL[dt]
    row["ok"] = bool(ok)
    if not ok:
        emit({tag: row})
        fail(f"a kernel disagrees with its plain version: {row}")
    # the same dq from a second launch, and the dQ kernel's own delta
    # against delta in torch ops (_bwd_delta, its plain version), in f32
    # at TOL
    dq2, delta = fa._flash_bwd_dq_cuda(q, k, v, o, do, lse, causal, scale,
                                       p, sd)
    row["dq_repeatable"] = bool(torch.equal(dq2, dq))
    ref_delta = fa._bwd_delta(o, do)
    big = max(1.0, ref_delta.abs().max().item())
    row["delta_max_abs_err"] = (delta - ref_delta).abs().max().item()
    row["delta_tol"] = (TOL[dt] if dt == "float32" else 1e-3) * big
    if not (row["delta_max_abs_err"] <= row["delta_tol"]
            and row["dq_repeatable"]):
        emit({tag: row})
        fail(f"the dQ kernel's delta or its dq is off: {row}")
    del dq2, ref_delta
    # dq_ms includes delta, which the kernel computes
    row["dq_ms"] = time_ms(lambda: fa._flash_bwd_dq_cuda(
        q, k, v, o, do, lse, causal, scale, p, sd), reps=10)
    row["dkv_ms"] = time_ms(lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, causal, scale, p, sd), reps=10)
    row["delta_torch_ms"] = time_ms(lambda: fa._bwd_delta(o, do),
                                    reps=10)
    row["backward_ms"] = row["dq_ms"] + row["dkv_ms"]
    for kern in ("dq", "dkv"):
        row[f"{kern}_plain_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal, scale, p, DROP_SEED,
                which=kern), reps=2, warmup=1)
    # SDPA's backward computes dq, dk and dv together: a yardstick for
    # the whole backward (backward_ms), not for one kernel
    lib_f, lib_fb = _sdpa_fb(torch, q, k, v, do, causal, scale, p)
    row["backward_library_ms"] = (time_ms(lib_fb, reps=10)
                                  - time_ms(lib_f, reps=10))
    for kern in ("dq", "dkv"):
        row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = bwd_bound_ms(
            kern, b_, s, sk, nh, hd, causal, dt)
    if with_fwd:
        # the forward beside SDPA's forward at the same dropout p
        row["fwd_ms"] = time_ms(lambda: fa._flash_fwd_cuda(
            q, k, v, causal, scale, p, sd), reps=20)
        row["fwd_plain_ms"] = time_ms(
            lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED),
            reps=2, warmup=1)
        row["fwd_library_ms"] = time_ms(lib_f, reps=20)
        bound = fwd_bound(b_, s, sk, nh, hd, causal, dt, p,
                          philox if hd == 64 else None)
        row["fwd_bound_ms"], row["fwd_bound_by"] = (bound["bound_ms"],
                                                    bound["bound_by"])
        row["fwd_bound"] = bound
    emit({tag: row})
    del q, k, v, do, o, lse, dq, dk, dv, ref
    torch.cuda.empty_cache()
    return row


def mask_probe_phase(torch, fa):
    """The kernels' own dropout masks, link for link, at the training
    path's shapes (b 48, s 512 and 200, non-causal; mask_probe_case; the
    f32 FFMA backward causal at s 512 too), at the f32 h-128 shape over
    the whole card (F32_H128_FULL, causal and not) and at
    Transformer-base's (b 32, n 8, h 64, MT_SHAPES, separate q, k and
    v)."""
    b, n = TRAIN_BATCH[0], BASE["num_attention_heads"]
    h = BASE["hidden_size"] // n
    rows = [mask_probe_case(torch, fa, b, n, h, s, dt, causal=False)
            for dt in ("bfloat16", "float32") for s in (TRAIN_BATCH[1], 200)]
    rows.append(mask_probe_case(torch, fa, b, n, h, TRAIN_BATCH[1],
                                "float32", causal=True))
    fb, fs, fn, fh = F32_H128_FULL[:4]
    rows += [mask_probe_case(torch, fa, fb, fn, fh, fs, "float32",
                             causal=causal) for causal in (False, True)]
    # Transformer-base (mt_cases' shapes and layout)
    return rows + [mask_probe_case(torch, fa, 32, 8, 64, sq, dt,
                                   causal=False, sk=sk, separate=True)
                   for dt in ("bfloat16", "float32")
                   for sq, sk in MT_SHAPES]


def mask_probe_case(torch, fa, b, n, h, s, dt, causal, sk=None,
                    separate=False):
    """One probe of the kernels' dropout masks, link for link, at s
    queries and sk keys (sk defaults to s; causal needs sk == s). q and
    k live on disjoint halves of head_dim (q[i, c] = 1 where c < h/2
    and i % (h/2) == c; k[j, c] = 1 where c >= h/2 and j % (h/2) == c -
    h/2), so QK^T = 0 and every probability of row i is 1/n_i, n_i the
    keys it sees (sk, or i + 1 causal).
    Forward: v[j, c] = 1 where j % h == c, so O[i, c] is the number of
    kept links (i, j) with j % h == c, times w_i = 1 / (n_i (1 - p)).
    Backward: v = 1 and dO[i, c] = n_i / sk where i % h == c (1 when
    non-causal), so every link weighs w = 1 / (sk (1 - p)). Then dV[j, c]
    counts the kept links (i, j) with i % h == c (times w); dQ[i, c],
    c >= h/2, sums keep/(1-p) - delta_i over the keys j % (h/2) == c -
    h/2, and dK[j, c], c < h/2, over the rows i % (h/2) == c (times
    scale n_i / sk). Every link lands in one element of each output, so
    a wrong bit moves that element by one link's weight (w_i for O, w
    for dV, scale w for dQ and dK): each kernel must agree with the plain
    version (the same Philox mask, f32 math, the same dO) to within half
    of it. Outputs stay small counts, so bf16 rounds them by far less
    than that. q, k and v are separate tensors where `separate`, else
    views of one qkv tensor (attention_inputs)."""
    sk = s if sk is None else sk
    if causal and sk != s:
        raise ValueError("the causal probe takes as many keys as queries")
    if not separate and sk != s:
        raise ValueError("views of one qkv take as many keys as queries")
    sd = seed_card(torch)
    half = h // 2
    dev = torch.device("cuda", 0)
    scale = 1.0 / math.sqrt(h)
    dtype = getattr(torch, dt)
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(sk, device=dev)[:, None]
    c = torch.arange(h, device=dev)[None, :]
    seen = (i[:, 0] + 1 if causal else torch.full((s,), sk, device=dev)
            ).double()
    if separate:
        q = torch.zeros((b, s, n, h), device=dev, dtype=dtype)
        k, v = (torch.zeros((b, sk, n, h), device=dev, dtype=dtype)
                for _ in range(2))
    else:
        qkv = torch.zeros((b, s, 3, n, h), device=dev, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q[:] = ((c < half) & (i % half == c))[None, :, None, :]
    k[:] = ((c >= half) & (j % half == c - half))[None, :, None, :]
    v[:] = (j % h == c)[None, :, None, :]
    w_row = (1.0 / (seen * (1.0 - DROP_P)))[None, :, None, None]
    w = 1.0 / (sk * (1.0 - DROP_P))
    o, _ = fa._flash_fwd_cuda(q, k, v, causal, scale, DROP_P, sd)
    o_ref, _ = fa.flash_attention_fwd_plain(
        q.float(), k.float(), v.float(), causal, scale, dropout_p=DROP_P,
        seed=DROP_SEED)
    err = {"o": ((o.double() - o_ref.double()).abs() / w_row).max().item()}
    # O / w_i are counts of kept links, each link in one of them
    links = b * n * int(seen.sum().item())
    kept = ((o.double() / w_row).round().sum() / links).item()
    del o_ref
    v[:] = 1
    do = ((i % h == c)[None, :, None, :] * (seen / sk)[None, :, None, None]
          ).expand(b, s, n, h).to(dtype).contiguous()
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, DROP_P, DROP_SEED)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, DROP_P,
                             sd)
    ref = fa.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal, scale, DROP_P, DROP_SEED)
    for name, a, r, unit in zip(("dq", "dk", "dv"), got, ref,
                                (scale * w, scale * w, w)):
        err[name] = (a.float() - r).abs().max().item() / unit
    row = dict(dtype=dt, b=b, s=s, sk=sk, n=n, h=h, causal=causal,
               dropout_p=DROP_P, layout=_layout(separate), links=links,
               kept_fraction=kept, expected=1.0 - DROP_P,
               max_err_in_links=err, tol_in_links=0.5)
    row["ok"] = (all(e < 0.5 for e in err.values())
                 and abs(kept - (1.0 - DROP_P)) < 1e-3)
    emit({"mask_probe": row})
    if not row["ok"]:
        fail(f"a kernel's dropout mask is off: {row}")
    del q, k, v, o, lse, do, got, ref
    torch.cuda.empty_cache()
    return row


def ffma_kernel_rows(path, cases):
    """The `kernels` line's rows of csrc/flash_attn_bwd.cu's f32 kernels
    at head_dim 64 and 128 (dq_ffma, dkv_ffma): timed at ERNIE-base's f32
    training shape (the bwd_kernel_case row at b 48, s 512, non-causal,
    DROP_P, qkv views), launched by the captured_train_f32 path (`path`,
    COUNTED_CALLS), with every f32 case at 64 and 128 beside them. Fails
    if the path launched no kernel of one kind."""
    def is_f32_head(c):
        return (c["dtype"] == "float32" and c["b"] == TRAIN_BATCH[0]
                and c["s"] == TRAIN_BATCH[1] and not c["causal"]
                and c["dropout_p"] == DROP_P and c["h"] == 64)
    head = next(c for c in cases if is_f32_head(c))
    f32 = [c for c in cases if c["dtype"] == "float32"
           and c["h"] in (64, 128)]
    rows = []
    for wrapper, t, pallas in (("flash_attn_bwd_dq", "dq", 283),
                               ("flash_attn_bwd_dkv", "dkv", 319)):
        route = F32_TRAIN_ROUTES[wrapper]
        err = (("dq",) if t == "dq" else ("dk", "dv"))
        rows.append(dict(
            name=f"{wrapper}_ffma", route="cuda",
            source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas_kernels.py:{pallas} (f32, "
                     "head_dim 64 and 128)",
            device_kernel=route, launches=path["launches"][wrapper],
            launches_per_step=path["launches_per_replay"][wrapper],
            max_abs_err=max(head[f"{e}_max_abs_err"] for e in err),
            ms=head[f"{t}_ms"], plain_ms=head[f"{t}_plain_ms"],
            bound_ms=head[f"{t}_bound_ms"], bound_by=head[f"{t}_bound_by"],
            library_ms=None, backward_ms=head["backward_ms"],
            backward_library_ms=head["backward_library_ms"],
            delta_max_abs_err=(head["delta_max_abs_err"] if t == "dq"
                               else None),
            shape="b48 s512 n12 h64 float32 non-causal dropout 0.1, qkv "
                  "views", path="captured_train_f32",
            path_step_ms=path["step_ms"],
            path_attention_share=path["attention_share"],
            cases=[{k: c[k] for k in (
                "b", "s", "sk", "n", "h", "causal", "dropout_p", "layout",
                f"{t}_ms", f"{t}_bound_ms", "backward_ms",
                "backward_library_ms", "delta_torch_ms")} for c in f32]))
        if path["launches"][wrapper] == 0:
            fail(f"the captured_train_f32 path launched no {route} kernel")
    return rows


def ffma_fwd_kernel_row(path, cases, kernel_cases, launches_inference):
    """The `kernels` line's row of csrc/flash_attn_fwd.cu's f32 forward at
    head_dim 64 and 128 (fwd_ffma): timed at ERNIE-base's f32 training
    shape (the bwd_kernel_case row at b 48, s 512, non-causal, DROP_P,
    qkv views) beside SDPA's forward there, launched by the
    captured_train_f32 path (`path`, COUNTED_CALLS) and by the f32
    inference pass (`launches_inference`), with every f32 case at 64 and
    128 of the backward phase (`cases`) and of the forward phase
    (`kernel_cases`) beside it. Fails if either path launched none."""
    head = next(c for c in cases if c["dtype"] == "float32"
                and c["b"] == TRAIN_BATCH[0] and c["s"] == TRAIN_BATCH[1]
                and not c["causal"] and c["dropout_p"] == DROP_P
                and c["h"] == 64)
    route = F32_TRAIN_ROUTES["flash_attn_fwd"]
    if path["launches"]["flash_attn_fwd"] == 0:
        fail(f"the captured_train_f32 path launched no {route} kernel")
    if launches_inference == 0:
        fail(f"the f32 inference pass launched no {route} kernel")

    def f32(rows):
        return [c for c in rows if c["dtype"] == "float32"
                and c["h"] in (64, 128)]
    keys = ("b", "s", "sk", "n", "h", "causal", "dropout_p", "layout")
    return dict(
        name="flash_attn_fwd_ffma", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        replaces="paddle_tpu/ops/pallas_kernels.py:175 (f32, head_dim 64 "
                 "and 128)",
        device_kernel=route, launches=path["launches"]["flash_attn_fwd"],
        launches_per_step=path["launches_per_replay"]["flash_attn_fwd"],
        launches_float32_inference_pass=launches_inference,
        max_abs_err=head["o_max_abs_err"],
        lse_max_abs_err=head["lse_max_abs_err"], ms=head["fwd_ms"],
        plain_ms=head["fwd_plain_ms"], bound_ms=head["fwd_bound_ms"],
        bound_by=head["fwd_bound_by"], library_ms=head["fwd_library_ms"],
        shape="b48 s512 n12 h64 float32 non-causal dropout 0.1, qkv views",
        path="captured_train_f32", path_step_ms=path["step_ms"],
        path_attention_share=path["attention_share"],
        cases=[dict({k: c[k] for k in keys}, ms=c["fwd_ms"],
                    library_ms=c["fwd_library_ms"],
                    bound_ms=c["fwd_bound_ms"],
                    max_abs_err=c["o_max_abs_err"]) for c in f32(cases)],
        kernel_cases=[dict({k: c[k] for k in keys}, ms=c["ms"],
                           library_ms=c["library_ms"],
                           bound_ms=c["bound_ms"],
                           max_abs_err=c["max_abs_err"])
                      for c in f32(kernel_cases)])


# head_dims run through kernel_head_dim at the cross-attention shape (b
# 32, n 8, sq 96, sk 128, separate q, k, v): nn.Transformer(256, 8)'s 32
# and 96 (padded to 64 and 128), 192 (padded to 256) and 256 itself
# (nn.MultiHeadAttention(4096, 16)'s head width)
PAD_HEAD_DIMS = (32, 96, 192, 256)
# head_dim 256: b, s, n, h of the kernel cases; in bf16 the three
# kernels on csrc/flash_attn_wg256.cu's wgmma kernels, in f32 on
# csrc/flash_attn_wide.cu's FFMA kernels (each a cluster of one CTA)
D256_SHAPE = (8, 1024, 8, 256)
WG256_SOURCE = "flash_attn_wg256"
# its instantiations: the forward, dQ and dK/dV x causal x dropout
WG256_INSTANTIATIONS = 12
# the device kernels of each wrapper at head_dim 256, by dtype
D256_ROUTES = {"bfloat16": {"flash_attn_fwd": "fwd_wg256",
                            "flash_attn_bwd_dq": "dq_wg256",
                            "flash_attn_bwd_dkv": "dkv_wg256"},
               "float32": {"flash_attn_fwd": "fwd_wide",
                           "flash_attn_bwd_dq": "dq_wide",
                           "flash_attn_bwd_dkv": "dkv_wide"}}


def d256_kernel_phase(torch, fa):
    """The forward, dQ and dK/dV kernels at head_dim 256 against their
    plain versions, row by row at TOL (bwd_kernel_case, the forward
    and the dQ kernel's own delta always held too), in f32 and bf16, at
    p 0 and DROP_P, causal and not, at D256_SHAPE, and at the attention
    shape of the encoder_256 phases (ENC256_ATTN in bf16,
    ENC256_ATTN_F32), with their times beside the bound and SDPA's; each
    case must launch each kernel once more. Then kernel_routes at 256
    (`d256_routes`)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    b, s, n, h = D256_SHAPE
    cases = [(b, s, n, h, causal, dt, p) for dt in ("float32", "bfloat16")
             for p in (0.0, DROP_P) for causal in (False, True)]
    cases += [ENC256_ATTN, ENC256_ATTN_F32]
    rows = []
    for case in cases:
        before = dict(fa.launches)
        row = bwd_kernel_case(torch, fa, gen, case, None, tag="d256_case",
                              with_fwd=True)
        kernel_clusters(torch, fa, row)
        # every kernel launched in the case (its timings too)
        row["launched"] = {k: fa.launches[k] - before[k]
                           for k in fa.launches}
        if not all(row["launched"].values()):
            fail(f"a head_dim-256 case launched no kernel of one kind: "
                 f"{row['launched']}")
        rows.append(row)
    kernel_routes(torch, fa, D256_ROUTES, 256, "d256_routes")
    return rows


def kernel_routes(torch, fa, routes, h, tag):
    """The device kernels one forward and backward at head_dim h ran in
    each dtype, by name, counted by torch.profiler: the kernels of
    routes[dtype] once each, and no other kernel of KERNEL_EVENTS;
    emitted under `tag`."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    scale = 1.0 / math.sqrt(h)
    out = {}
    for dt, want in routes.items():
        q, k, v = attention_inputs(torch, gen, 2, 256, 256, 2, h,
                                   getattr(torch, dt), False)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)

        def fwd_bwd():
            o, lse = fa._flash_fwd_cuda(q, k, v, False, scale)
            fa._flash_bwd_cuda(q, k, v, o, lse, do, False, scale)
        seen = device_profile(torch, fwd_bwd, 1)["routes"]
        out[dt] = {key: n for key, n in seen.items() if n}
        if out[dt] != {name: 1 for name in want.values()}:
            emit({tag: out})
            fail(f"a {dt} forward and backward at head_dim {h} ran "
                 f"{out[dt]}, expected {sorted(want.values())} once each")
    emit({tag: out})
    return out


def d256_mask_probe_phase(torch, fa):
    """The head_dim-256 kernels' own dropout masks, link for link
    (mask_probe_case), f32 (the cluster FFMA kernels) and bf16 (the
    wgmma kernels), causal and not, at D256_SHAPE."""
    b, s, n, h = D256_SHAPE
    return [mask_probe_case(torch, fa, b, n, h, s, dt, causal=causal)
            for dt in ("bfloat16", "float32") for causal in (False, True)]


def kernel_clusters(torch, fa, row):
    """Set row["clusters"]: the cluster ({size, chunks_per_cta}) each of
    the row's three kernels ran in, by wrapper name (fa.kernel_cluster:
    csrc/flash_attn_wide.cu's f32 kernels, a cluster of one at 256),
    None for a kernel that runs none."""
    dt = getattr(torch, row["dtype"])
    row["clusters"] = {}
    for name in KERNEL_EVENTS:
        cl = fa.kernel_cluster(f"pt_{name}", row["h"], dt)
        row["clusters"][name] = (None if cl is None else
                                 dict(zip(("size", "chunks_per_cta"), cl)))


def d256_kernel_rows(cases):
    """{kernel: [per-case times, errors and bounds]} of the head_dim-256
    cases (and above it, wide_kernel_rows), for the `kernels` line's
    rows; `kernel` names the device kernel of the case's dtype
    (D256_ROUTES, WIDE_ROUTES), `cluster` its cluster (kernel_clusters;
    None in a row without them)."""
    keys = {"flash_attn_fwd": ("fwd", "o"), "flash_attn_bwd_dq": ("dq", "dq"),
            "flash_attn_bwd_dkv": ("dkv", "dk")}
    out = {}
    for name, (t, e) in keys.items():
        out[name] = [dict(
            kernel=(D256_ROUTES if c["h"] == 256
                    else WIDE_ROUTES)[c["dtype"]][name],
            dtype=c["dtype"], b=c["b"], s=c["s"], sk=c["sk"], n=c["n"],
            h=c["h"], layout=c["layout"],
            causal=c["causal"], dropout_p=c["dropout_p"],
            ms=c[f"{t}_ms"], plain_ms=c[f"{t}_plain_ms"],
            bound_ms=c[f"{t}_bound_ms"], bound_by=c[f"{t}_bound_by"],
            device_ms=c.get(f"{t}_device_ms"),
            library_ms=c["fwd_library_ms"] if t == "fwd" else None,
            backward_library_ms=(None if t == "fwd"
                                 else c["backward_library_ms"]),
            max_abs_err=(c[f"{e}_max_abs_err"] if t != "dkv" else
                         max(c["dk_max_abs_err"], c["dv_max_abs_err"])),
            cluster=c.get("clusters", {}).get(name))
            for c in cases]
    return out


# A training step at head_dim 256 (nn.MultiHeadAttention(4096, 16)'s
# head width): nn.TransformerEncoderLayer(4096, 16, 16384) of the port's
# nn (paddle's post-norm, ReLU, dropout 0.1 on the residuals, the FFN
# and the attention weights), 8 sequences of 1024 tokens, O1 bf16,
# AdamW(1e-4, weight decay 0.01), an MSE loss against a target; random
# weights, inputs and target from SEED
ENC256 = dict(d_model=4096, nhead=16, dim_feedforward=16384, dropout=0.1)
ENC256_BATCH = (8, 1024)
ENC256_WARMUP, ENC256_STEPS = 2, 5
# its attention as the kernels see it: b, sq, n, h, causal, dtype, p,
# sk, separate q, k and v (MultiHeadAttention's three projections)
ENC256_ATTN = (8, 1024, 16, 256, False, "bfloat16", DROP_P, 1024, True)
# the same step above head_dim 256: nn.TransformerEncoderLayer(4096, 8,
# 16384), head_dim 512 (nn.MultiHeadAttention(4096, 8)'s head width), on
# the three wgmma kernels of csrc/flash_attn_wgwide.cu
ENCWIDE = dict(ENC256, nhead=8)
ENCWIDE_ATTN = (8, 1024, 8, 512, False, "bfloat16", DROP_P, 1024, True)
# encoder_256's and encoder_wide's steps in f32 with no AMP
# (encoder_256_f32, encoder_wide_f32): the three f32 kernels of
# csrc/flash_attn_wide.cu at ENC256_ATTN's and ENCWIDE_ATTN's shapes
ENC256_ATTN_F32 = ENC256_ATTN[:5] + ("float32",) + ENC256_ATTN[6:]
ENCWIDE_ATTN_F32 = ENCWIDE_ATTN[:5] + ("float32",) + ENCWIDE_ATTN[6:]


def encoder_256_phase(torch, pt, fa, key="encoder_256"):
    """One layer of ENCODERS[key]'s config trained through the captured
    TrainStep at ENC256_BATCH, O1 bf16 or f32 with no AMP as ENCODERS
    says. From one start state, the first call (its
    eager warm-up, then the capture) and one replay at STEP_SEEDS[:2]
    against two eager steps: losses and every parameter bit-equal. The
    attention kernels a replay runs, counted on the card by
    torch.profiler (profile_step): each of the three once, by the names
    ENCODERS[key] gives (the three wgmma kernels of head_dim 256, or of
    512; in f32 the three FFMA kernels). Then ENC256_WARMUP +
    ENC256_STEPS replays on a synchronised host clock: step ms beside a
    replay's device ms by category and attention's share of it, the idle
    share, tokens/s, peak memory over the first call. The kernels'
    counts are zeroed just before the path."""
    from paddle_tpu_torch.static import TrainStep
    cfg, routes, amp, _ = ENCODERS[key]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    b, s = ENC256_BATCH
    d = cfg["d_model"]
    pt.seed(SEED)
    model = pt.nn.TransformerEncoderLayer(**cfg, device="cuda")
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters(),
                             weight_decay=0.01)
    step = TrainStep(model, pt.nn.functional.mse_loss, opt,
                     amp_level=amp, amp_dtype="bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x, y = (torch.randn((b, s, d), generator=gen, device="cuda")
            for _ in range(2))
    seeds = STEP_SEEDS[:2]
    s0 = step.state_dict()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa)
    graph_losses = []
    for sd in seeds:
        graph_losses.append(float(step(x, y, seed=sd)))
        if len(graph_losses) == 1:
            warm = dict(step.last_launches)
            peak = torch.cuda.max_memory_allocated()
    graph_params = _snapshot(step)
    step.set_state_dict(s0)
    del s0
    eager_losses = [float(step.eager_step(x, y, seed=sd)) for sd in seeds]
    eager_params = _snapshot(step)
    cap = dict(steps=len(seeds), step_seeds=seeds,
               graph_losses=graph_losses, eager_losses=eager_losses,
               losses_bit_equal=graph_losses == eager_losses,
               params_bit_equal=_bit_equal(graph_params, eager_params),
               params_max_abs_diff=_max_abs_diff(graph_params, eager_params))
    del graph_params, eager_params
    prof = profile_step(torch, step, x, y)
    for _ in range(ENC256_WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(ENC256_STEPS):
        last = step(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    step_ms = secs / ENC256_STEPS * 1e3
    attn_ms = prof["categories"].get("flash attention kernels", 0.0)
    kernel_ms = {name: sum(r["ms"] for r in prof["top"] if name in r["name"])
                 for name in routes.values()}
    row = dict(card=nvidia_smi(), model="nn.TransformerEncoderLayer",
               config=dict(cfg, head_dim=d // cfg["nhead"]),
               batch=b, seq=s,
               amp=f"{amp} bfloat16" if amp else "none (float32)",
               optimizer="AdamW(1e-4, weight_decay=0.01)", loss="mse_loss",
               params=sum(p.numel() for p in step.params),
               captured_vs_eager=cap, graphs=step.programs,
               captures=step.captures, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               warmup_launches=warm,
               launches_per_step=prof["launches_per_replay"],
               routes_per_step={k: v for k, v in
                                prof["routes_per_replay"].items() if v},
               launches=_sum_launches([warm, prof["kernel_launches"]]),
               counted_calls=COUNTED_CALLS,
               losses=graph_losses + [float(last)],
               warmup_steps=ENC256_WARMUP, timed_steps=ENC256_STEPS,
               step_ms=step_ms, device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               attention_ms_per_step=attn_ms,
               attention_share=attn_ms / prof["device_ms"],
               attention_kernel_ms=kernel_ms,
               tokens_per_s=b * s * ENC256_STEPS / secs,
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base,
               kernel_launches_per_replay=prof["events"],
               profile=_profile_row(prof, top=12))
    step.release()
    del model, step, x, y
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    emit({key: row})
    bad = encoder_256_gates(row, routes)
    if bad:
        fail(f"{key}: " + "; ".join(bad))
    return row


def encoder_256_gates(row, routes=D256_ROUTES["bfloat16"]):
    """An ENCODERS phase's failures (encoder_256's by default), each a
    message (empty: ok); routes: the kernel names a replay must run once
    each."""
    bad = []
    cap = row["captured_vs_eager"]
    if not (cap["losses_bit_equal"] and cap["params_bit_equal"]):
        bad.append(f"the replay is not bit-equal to the eager step: {cap}")
    if row["graphs"] != 1 or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events for one signature")
    one = {k: 1 for k in KERNEL_EVENTS}
    if row["launches_per_step"] != one or row["warmup_launches"] != one:
        bad.append(f"attention launches a step {row['launches_per_step']}"
                   f" (warm-up {row['warmup_launches']}), expected one of "
                   "each")
    want = {name: 1 for name in routes.values()}
    if row["routes_per_step"] != want:
        bad.append(f"a replay ran {row['routes_per_step']}, expected "
                   f"{want}")
    if not all(math.isfinite(v) for v in row["losses"]):
        bad.append(f"non-finite losses {row['losses']}")
    return bad


def encoder_kernel_rows(paths, cases):
    """The `kernels` line's rows of the paths at head_dim 256
    (encoder_256: the three wgmma kernels of csrc/flash_attn_wg256.cu;
    encoder_256_f32: the three FFMA kernels of csrc/flash_attn_wide.cu)
    and 512 (encoder_wide: the three of csrc/flash_attn_wgwide.cu;
    encoder_wide_f32: the three FFMA kernels of csrc/flash_attn_wide.cu):
    paths maps each phase to its row, and each kernel is timed at its
    path's attention shape (ENCODERS[key][3]: the kernel case of `cases`
    at that shape); launches: the path's (COUNTED_CALLS). Fails if a
    path launched no kernel of one kind."""
    pallas = {"fwd": 175, "dq": 283, "dkv": 319}
    outs = {"fwd": ("o",), "dq": ("dq",), "dkv": ("dk", "dv")}
    srcs = {"wg256": "flash_attn_wg256", "wgwide": "flash_attn_wgwide",
            "wide": "flash_attn_wide"}
    rows = []
    for key, path in paths.items():
        attn = ENCODERS[key][3]
        layer = next(c for c in cases if "fwd_ms" in c
                     and c["n"] == attn[2] and c["h"] == attn[3]
                     and c["dtype"] == attn[5]
                     and c["layout"] == _layout(attn[8]))
        layer_shape = ("b{} sq{} n{} h{} {} non-causal dropout {}, "
                       "separate q, k and v".format(*attn[:4], attn[5],
                                                    attn[6]))
        for wrapper, route in ENCODERS[key][1].items():
            t = wrapper.rsplit("_", 1)[-1]
            tail = route.split("_", 1)[1]
            name = f"{wrapper}_{tail}"
            rows.append(dict(
                name=name, route="cuda",
                source=f"paddle_tpu_torch/csrc/{srcs[tail]}.cu",
                replaces=f"paddle_tpu/ops/pallas_kernels.py:{pallas[t]} "
                         "(head_dim {}, the Pallas wrapper's padding at "
                         ":486-493)".format(attn[3]),
                device_kernel=route,
                launches=path["launches"][wrapper],
                launches_per_step=path["launches_per_step"][wrapper],
                max_abs_err=max(layer[f"{o}_max_abs_err"]
                                for o in outs[t]),
                ms=layer[f"{t}_ms"], plain_ms=layer[f"{t}_plain_ms"],
                device_ms=layer.get(f"{t}_device_ms"),
                bound_ms=layer[f"{t}_bound_ms"],
                bound_by=layer[f"{t}_bound_by"],
                library_ms=layer["fwd_library_ms"] if t == "fwd" else None,
                backward_ms=None if t == "fwd" else layer["backward_ms"],
                backward_library_ms=(None if t == "fwd"
                                     else layer["backward_library_ms"]),
                shape=layer_shape, path=key,
                path_step_ms=path["step_ms"],
                path_attention_share=path["attention_share"]))
            if path["launches"][wrapper] == 0:
                fail(f"the {key} path launched no {name} kernel")
    return rows


# head_dim above 256 on csrc/flash_attn_wide.cu's f32 FFMA kernels and
# csrc/flash_attn_wgwide.cu's bf16 wgmma kernels: b, s, n at every
# head_dim of WIDE_HEAD_DIMS (320 runs zero-padded to 512 through the
# autograd entry, the others on the kernels' own entries); the shape is
# small because the plain versions run beside every case
WIDE_SHAPE = (2, 512, 4)
WIDE_HEAD_DIMS = (320, 512, 1024)
WIDE_SOURCE = "flash_attn_wide"
GRAPH_WHILE_SOURCE = "graph_while"
# its instantiations: the forward, and dQ and dK/dV at one chunk (no
# cluster barrier) and at more, in f32 x causal x dropout
WIDE_INSTANTIATIONS = (1 + 2 * 2) * 2 * 2
# the bf16 kernels above 256 (wgmma): 3 x causal x dropout
WGWIDE_SOURCE = "flash_attn_wgwide"
WGWIDE_INSTANTIATIONS = 12
# bf16 cases above 256 that the WIDE_SHAPE cases do not reach, on the
# kernels' own entries: causal cross-attention with sq < sk (key blocks
# no query sees) and sq > sk, a ragged length (200: not a multiple of
# the 32- and 64-row tiles), a single head (qkv views: its strides given
# as a packed tensor's) and D 768 (three chunks)
WIDE_HARD_CASES = [(2, 384, 4, 512, True, "bfloat16", DROP_P, 640, True),
                   (2, 640, 4, 512, True, "bfloat16", 0.0, 384, True),
                   (2, 200, 4, 1024, True, "bfloat16", DROP_P),
                   (2, 200, 4, 1024, False, "bfloat16", 0.0),
                   (4, 512, 1, 512, True, "bfloat16", DROP_P),
                   (2, 512, 4, 768, False, "bfloat16", DROP_P),
                   (2, 512, 4, 768, True, "bfloat16", 0.0)]
# their f32 twins on csrc/flash_attn_wide.cu's cluster backward, and D
# 2304 (nine chunks: more than a portable cluster of 8 CTAs, so a CTA
# owns two; fa.wide_cluster) at a small shape, p 0 and DROP_P, causal and
# not
WIDE_HARD_CASES_F32 = [c[:5] + ("float32",) + c[6:] for c in WIDE_HARD_CASES]
WIDE_2304_CASES = [(1, 128, 2, 2304, causal, "float32", p)
                   for p in (0.0, DROP_P) for causal in (False, True)]
# the device kernels of each wrapper above head_dim 256, by dtype
WIDE_ROUTES = {"bfloat16": {"flash_attn_fwd": "fwd_wgwide",
                            "flash_attn_bwd_dq": "dq_wgwide",
                            "flash_attn_bwd_dkv": "dkv_wgwide"},
               "float32": {"flash_attn_fwd": "fwd_wide",
                           "flash_attn_bwd_dq": "dq_wide",
                           "flash_attn_bwd_dkv": "dkv_wide"}}
# phase -> (layer config, the kernels a step runs, AMP level, its
# attention as the kernel cases see it)
ENCODERS = {"encoder_256": (ENC256, D256_ROUTES["bfloat16"], "O1",
                            ENC256_ATTN),
            "encoder_256_f32": (ENC256, D256_ROUTES["float32"], None,
                                ENC256_ATTN_F32),
            "encoder_wide": (ENCWIDE, WIDE_ROUTES["bfloat16"], "O1",
                             ENCWIDE_ATTN),
            "encoder_wide_f32": (ENCWIDE, WIDE_ROUTES["float32"], None,
                                 ENCWIDE_ATTN_F32)}


def wide_kernel_phase(torch, fa):
    """The forward, dQ and dK/dV kernels above head_dim 256 against their
    plain versions, row by row at TOL, f32 and bf16, p 0 and DROP_P,
    causal and not, at WIDE_SHAPE: bwd_kernel_case at the head_dims the
    kernels take (512, 1024; the dQ kernel's own delta held too), and
    the autograd entry at 320 (pad_case: padded to 512 on the card,
    against the plain versions at 320); and at the attention shape of the
    encoder_wide phases (ENCWIDE_ATTN in bf16, ENCWIDE_ATTN_F32). Each
    case must launch every kernel, and times each kernel alone
    (wide_device_ms); an f32 row names its clusters (kernel_clusters)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    b, s, n = WIDE_SHAPE
    cases = [((b, s, n, h, causal, dt, p) if fa.kernel_head_dim(h) == h
              else (b, s, n, h, causal, dt, p, s, True))
             for h in WIDE_HEAD_DIMS for dt in ("float32", "bfloat16")
             for p in (0.0, DROP_P) for causal in (False, True)]
    cases += [ENCWIDE_ATTN, ENCWIDE_ATTN_F32]
    rows = []
    for case in cases:
        b_, s_, n_, h, causal, dt, p, sk, sep = _unpack(case)
        before = dict(fa.launches)
        if fa.kernel_head_dim(h) == h:
            row = bwd_kernel_case(torch, fa, gen, case, None,
                                  tag="wide_case", with_fwd=True)
            for t, ms in wide_device_ms(torch, fa, gen, case).items():
                row[f"{t}_device_ms"] = ms
            kernel_clusters(torch, fa, row)
        else:
            row = pad_case(torch, fa, gen, b_, s_, sk, n_, h, dt, p, causal,
                           tag="wide_case", separate=sep)
        row["launched"] = {k: fa.launches[k] - before[k]
                           for k in fa.launches}
        if not all(row["launched"].values()):
            fail(f"a head_dim-{h} case launched no kernel of one kind: "
                 f"{row['launched']}")
        rows.append(row)
    return rows


def wide_device_ms(torch, fa, gen, case, runs=5):
    """{fwd, dq, dkv: device ms} of the forward, dQ and dK/dV kernels at
    `case` (bwd_kernel_case's tuple), by torch.profiler over a forward
    and backward: each kernel alone, where time_ms also counts the
    host's cost of each call, which is more than the kernel's at
    WIDE_SHAPE."""
    b, s, n, h, causal, dt, p, sk, sep = _unpack(case)
    q, k, v = attention_inputs(torch, gen, b, s, sk, n, h,
                               getattr(torch, dt), sep)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    sd = seed_card(torch)
    scale = 1.0 / math.sqrt(h)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)

    def fwd_bwd():
        fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)
        fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, p, sd)
    top = device_profile(torch, fwd_bwd, runs)["top"]
    return {t: sum(r["ms"] for r in top if WIDE_ROUTES[dt][name] in r["name"])
            for t, name in (("fwd", "flash_attn_fwd"),
                            ("dq", "flash_attn_bwd_dq"),
                            ("dkv", "flash_attn_bwd_dkv"))}


def wide_hard_phase(torch, fa):
    """The kernels above head_dim 256 at WIDE_HARD_CASES, in bf16 and f32
    (WIDE_HARD_CASES_F32), and at D 2304 in f32 (WIDE_2304_CASES), on
    their own entries: bwd_kernel_case against the plain versions row by
    row at TOL (the dQ kernel's own delta and a second dq launch too),
    each case launching every kernel; then the device kernels a forward
    and backward at D 768 runs in each dtype, by name (kernel_routes)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    rows = []
    for case in WIDE_HARD_CASES + WIDE_HARD_CASES_F32 + WIDE_2304_CASES:
        before = dict(fa.launches)
        row = bwd_kernel_case(torch, fa, gen, case, None,
                              tag="wide_hard_case", with_fwd=True)
        kernel_clusters(torch, fa, row)
        row["launched"] = {k: fa.launches[k] - before[k]
                           for k in fa.launches}
        if not all(row["launched"].values()):
            fail(f"a head_dim-{case[3]} case launched no kernel of one "
                 f"kind: {row['launched']}")
        rows.append(row)
    kernel_routes(torch, fa, WIDE_ROUTES, 768, "wide_routes")
    return rows


def sdpa_f32_routes_phase(torch):
    """The device kernels of SDPA's f32 forward, and of its forward and
    backward, at WIDE_SHAPE and head_dim 512 and 1024 (non-causal, p 0,
    TF32 off as main sets it), by name with their device ms a call
    (torch.profiler): the route behind the f32 rows' library column,
    whose products may run on the tensor cores (3xTF32) where the wide
    kernels run exact FFMA."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 41)
    b, s, n = WIDE_SHAPE
    out = {}
    for h in (512, 1024):
        q, k, v = attention_inputs(torch, gen, b, s, s, n, h, torch.float32,
                                   False)
        do = torch.randn(q.shape, generator=gen, device=dev)
        fwd, fwd_bwd = _sdpa_fb(torch, q, k, v, do, False,
                                1.0 / math.sqrt(h), 0.0)
        out[h] = {what: [dict(name=r["name"], ms=r["ms"], calls=r["calls"])
                         for r in device_profile(torch, fn, 3)["top"][:8]]
                  for what, fn in (("forward", fwd),
                                   ("forward_backward", fwd_bwd))}
        del q, k, v, do
    out["flags"] = dict(
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        flash_sdp=torch.backends.cuda.flash_sdp_enabled(),
        mem_efficient_sdp=torch.backends.cuda.mem_efficient_sdp_enabled(),
        math_sdp=torch.backends.cuda.math_sdp_enabled())
    emit({"sdpa_f32_routes": out})
    return out


def wide_mask_probe_phase(torch, fa):
    """The wide kernels' own dropout masks, link for link
    (mask_probe_case), f32 and bf16, causal and not, at head_dims 512
    and 1024 of WIDE_SHAPE."""
    b, s, n = WIDE_SHAPE
    return [mask_probe_case(torch, fa, b, n, h, s, dt, causal=causal)
            for h in WIDE_HEAD_DIMS if fa.kernel_head_dim(h) == h
            for dt in ("bfloat16", "float32") for causal in (False, True)]


def wide_kernel_rows(cases):
    """{kernel: rows} of the wide cases on the kernels' own entries (the
    padded 320 cases time the autograd entry as a whole)."""
    return d256_kernel_rows([c for c in cases if "fwd_ms" in c])


def pad_case(torch, fa, gen, b, s, sk, n, h, dt, p, causal,
             tag="head_pad_case", separate=True):
    """flash_attention_fwd, the autograd entry, at a head_dim the kernels
    run padded: O, lse and dQ, dK, dV through the kernels against the
    plain versions at the unpadded head_dim, row by row at TOL; the
    launches it made; and the entry's forward + backward time."""
    sd = seed_card(torch)
    dev = torch.device("cuda", 0)
    q, k, v = (t.requires_grad_() for t in attention_inputs(
        torch, gen, b, s, sk, n, h, getattr(torch, dt), separate))
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                    seed=sd)
    o.backward(do)
    torch.cuda.synchronize()
    launched = {name: fa.launches[name] - before[name]
                for name in fa.launches}
    scale = 1.0 / math.sqrt(h)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    o_ref, lse_ref = fa.flash_attention_fwd_plain(
        qd, kd, vd, causal, scale, dropout_p=p, seed=DROP_SEED)
    ref = fa.flash_attention_bwd_plain(
        qd, kd, vd, o.detach(), lse, do, causal, scale, p, DROP_SEED)
    row = dict(dtype=dt, b=b, s=s, sk=sk, n=n, h=h,
               kernel_head_dim=fa.kernel_head_dim(h), causal=causal,
               dropout_p=p, layout=_layout(separate), launches=launched,
               lse_max_abs_err=(lse - lse_ref).abs().max().item(),
               tol=TOL[dt])
    ok = row["lse_max_abs_err"] <= TOL[dt] and all(launched.values())
    for name, got, want in zip(("o", "dq", "dk", "dv"),
                               (o, q.grad, k.grad, v.grad), (o_ref, *ref)):
        err, ratio, good = _row_err_ok(got, want, dt)
        row[f"{name}_max_abs_err"], row[f"{name}_worst_row"] = err, ratio
        ok &= good
    row["ok"] = bool(ok)

    def entry():
        out, _ = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        dropout_p=p, seed=sd)
        out.backward(do)
    row["entry_fwd_bwd_ms"] = time_ms(entry, reps=3, warmup=1)
    emit({tag: row})
    if not ok:
        fail(f"flash attention at a padded head_dim disagrees with its "
             f"plain version or launched no kernel: {row}")
    del q, k, v, do, o, lse, o_ref, lse_ref, ref
    torch.cuda.empty_cache()
    return row


# the captured while_loop (csrc/graph_while.cu): Collatz trip counts, a
# batch of starting values per replay (the loop runs until every lane
# reached 1), each replay's inputs giving other trip counts
COLLATZ_INPUTS = ([27, 97, 1, 6], [871, 3, 7, 9], [1, 1, 1, 1],
                  [6171, 77031, 2, 5])
COLLATZ_TIMED = 20


def _collatz(torch, tcf, x):
    """(steps per lane, the lanes' final values, trips): while any lane
    of x is above 1, every such lane takes one Collatz step and counts
    it."""
    def cond(v, c, t):
        return (v != 1).any()

    def body(v, c, t):
        live = v != 1
        nxt = torch.where(v % 2 == 0, v // 2, 3 * v + 1)
        return torch.where(live, nxt, v), c + live.to(c.dtype), t + 1
    zero = torch.zeros_like(x)
    return tcf.while_loop(cond, body, [x, zero, zero[:1].sum()])


def graph_while_phase(torch, pt):
    """while_loop inside a CUDA-graph capture (static/capture.py's
    capture): one graph holding a conditional WHILE node, replayed with
    inputs whose trip counts differ; every replay's steps, values and
    trip count equal the eager (host) loop's, one graph is captured and
    the sentinel fires no event. Times: a replay against the eager loop
    on the same input."""
    from paddle_tpu_torch.ops import control_flow as tcf
    from paddle_tpu_torch.observability.sentinel import RecompileSentinel
    from paddle_tpu_torch.static import capture as cap
    dev = torch.device("cuda", 0)
    inp = torch.tensor(COLLATZ_INPUTS[0], dtype=torch.int64, device=dev)
    before = dict(tcf.launches)
    graph, out = cap.capture(lambda: _collatz(torch, tcf, inp), dev,
                             program="graph_while")
    captured = {k: tcf.launches[k] - before[k] for k in tcf.launches}
    sentinel = RecompileSentinel("graph_while")
    rows = []
    for vals in COLLATZ_INPUTS:
        inp.copy_(torch.tensor(vals, dtype=torch.int64))
        graph.replay()
        got = [t.clone() for t in out]
        want = _collatz(torch, tcf, torch.tensor(vals, dtype=torch.int64,
                                                 device=dev))
        sentinel.observe(1, expected=1, signature=("collatz", len(vals)))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        rows.append(dict(inputs=vals, steps=got[1].tolist(),
                         trips=int(got[2]), equal_to_eager=same))
        if not same:
            emit({"graph_while": rows})
            fail(f"the captured while_loop differs from the eager loop on "
                 f"{vals}: {[t.tolist() for t in got]} against "
                 f"{[t.tolist() for t in want]}")
    inp.copy_(torch.tensor(COLLATZ_INPUTS[-1], dtype=torch.int64))
    ms = time_ms(graph.replay, reps=COLLATZ_TIMED)
    eager_ms = time_ms(lambda: _collatz(torch, tcf, inp), reps=3, warmup=1)
    trips = rows[-1]["trips"]
    carry_bytes = 3 * inp.numel() * 8
    # each trip reads and writes the carries once; its integer ops (about
    # 8 a lane) priced at the FP32 pipes' rate
    bound = _bound(trips * 2 * carry_bytes, trips * 8 * inp.numel(),
                   "float32")
    row = dict(rows=rows, graphs=1, sentinel_fired=sentinel.fired,
               set_condition_launches_captured=captured,
               replay_ms=ms, eager_loop_ms=eager_ms, trips_timed=trips,
               bound_ms=bound[0], bound_by=bound[1],
               cuda_versions=tcf._graph_lib_checked[0])
    emit({"graph_while": row})
    if sentinel.fired or len(set(r["trips"] for r in rows)) < 3:
        fail(f"graph_while: {sentinel.fired} sentinel events, or too few "
             f"distinct trip counts: {rows}")
    del graph, out
    torch.cuda.empty_cache()
    return row


def collatz_static(x):
    """The Collatz loop of graph_while_phase written as plain Python (a
    tensor-dependent `while`), for to_static's AST conversion
    (paddle_tpu_torch/jit/dy2static.py): (final values, steps per lane,
    trips)."""
    c = x * 0
    t = c[:1].sum()
    live = x != 1
    nxt = x
    while (x != 1).any():
        live = x != 1
        nxt = (x // 2).where(x % 2 == 0, 3 * x + 1)
        x = nxt.where(live, x)
        c = c + live.to(c.dtype)
        t = t + 1
    return x, c, t


def to_static_while_phase(torch, pt):
    """to_static over collatz_static on the card with grad off: the first
    call is the warm-up (the `while` runs on the host, reading the
    predicate) and the capture, where dy2static's while_ goes to
    ops/control_flow.py while_loop, a conditional WHILE node
    (csrc/graph_while.cu); every replay on COLLATZ_INPUTS (different trip
    counts, one signature, one graph) equals the eager function. Times:
    a replay against the eager function."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.ops import control_flow as tcf
    dev = torch.device("cuda", 0)
    fn = to_static(collatz_static)
    before = dict(tcf.launches)
    rows = []
    with torch.no_grad():
        for vals in COLLATZ_INPUTS:
            inp = torch.tensor(vals, dtype=torch.int64, device=dev)
            got = [t.clone() for t in fn(inp)]
            want = collatz_static(inp)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            rows.append(dict(inputs=vals, steps=got[1].tolist(),
                             trips=int(got[2]), equal_to_eager=same))
        recorded = {k: tcf.launches[k] - before[k] for k in tcf.launches}
        inp = torch.tensor(COLLATZ_INPUTS[-1], dtype=torch.int64,
                           device=dev)
        ms = time_ms(lambda: fn(inp), reps=COLLATZ_TIMED)
        eager_ms = time_ms(lambda: collatz_static(inp), reps=3, warmup=1)
    row = dict(rows=rows, graphs=fn.programs, captures=fn.captures,
               replays=fn.replays, set_condition_launches_captured=recorded,
               replay_ms=ms, eager_ms=eager_ms)
    emit({"to_static_while": row})
    bad = [r for r in rows if not r["equal_to_eager"]]
    if bad or fn.programs != 1 or fn.captures != 1 or \
            not recorded["graph_while_set_condition"] or \
            len(set(r["trips"] for r in rows)) < 3:
        fail(f"to_static_while: {row}")
    fn.release()
    return row


def head_pad_phase(torch, fa):
    """flash_attention_fwd (the autograd entry MultiHeadAttention
    reaches) at each of PAD_HEAD_DIMS, f32 at p 0 and bf16 at p DROP_P,
    at the cross-attention shape (b 32, sq 96, sk 128, n 8, separate q,
    k, v): O, lse and dQ, dK, dV through the kernels (each must launch)
    against the plain versions at the unpadded head_dim, held row by
    row at TOL (pad_case)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    rows = [pad_case(torch, fa, gen, 32, 96, 128, 8, h, dt, p, False)
            for h in PAD_HEAD_DIMS
            for dt, p in (("float32", 0.0), ("bfloat16", DROP_P))]
    torch.cuda.empty_cache()
    return rows


def run_batches(torch, pt, fa, model, dtype_name, gen, keep):
    dev = torch.device("cuda", 0)
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    out = []
    kept = None
    for b, s in BATCHES:
        ids = torch.randint(0, vocab, (b, s), generator=gen, device=dev)
        tt = torch.randint(0, 2, (b, s), generator=gen, device=dev)
        before = fa.launches["flash_attn_fwd"]
        with pt.no_grad():
            logits, nsp = model(ids, tt)
        torch.cuda.synchronize()
        per_forward = fa.launches["flash_attn_fwd"] - before
        if per_forward != layers:
            fail(f"{dtype_name} {b}x{s}: {per_forward} kernel launches in "
                 f"one forward, expected {layers}")
        if tuple(logits.shape) != (b, s, vocab) or \
                tuple(nsp.shape) != (b, 2):
            fail(f"{dtype_name} {b}x{s}: output shapes "
                 f"{tuple(logits.shape)}, {tuple(nsp.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(nsp).all()):
            fail(f"{dtype_name} {b}x{s}: non-finite outputs")
        if (b, s) == keep:
            kept = logits.float().cpu()
        del logits, nsp
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            with pt.no_grad():
                lg, ns = model(ids, tt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del lg, ns
        ms = sorted(times)[2]
        row = dict(dtype=dtype_name, batch=b, seq=s,
                   launches_per_forward=per_forward, latency_ms=ms,
                   tokens_per_s=b * s / (ms / 1e3))
        emit({"main_path": row})
        out.append(row)
    return out, kept


def main_path(torch, pt, fa):
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    cfg = ErnieConfig.base(**BASE)
    pt.seed(SEED)
    model = ErnieForPretraining(cfg, device="cuda").eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    keep = BATCHES[-1]

    fa.launches["flash_attn_fwd"] = 0
    rows, f32_logits = run_batches(torch, pt, fa, model, "float32", gen, keep)
    launches_f32 = fa.launches["flash_attn_fwd"]

    # the card against the CPU, same weights, plain path on the CPU
    b, s = CPU_BATCH
    g = torch.Generator().manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    tt = torch.randint(0, 2, (b, s), generator=g)
    cpu_model = ErnieForPretraining(cfg, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with pt.no_grad():
        lg_cpu, nsp_cpu = cpu_model(ids, tt)
        lg_gpu, nsp_gpu = model(ids.cuda(), tt.cuda())
    err_lg = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    err_nsp = (nsp_gpu.cpu() - nsp_cpu).abs().max().item()
    cpu_ok = (torch.allclose(lg_gpu.cpu(), lg_cpu, atol=1e-3, rtol=1e-3)
              and torch.allclose(nsp_gpu.cpu(), nsp_cpu, atol=1e-3,
                                 rtol=1e-3))
    emit({"card_vs_cpu": dict(batch=b, seq=s, mlm_max_abs_err=err_lg,
                              nsp_max_abs_err=err_nsp, tol=1e-3,
                              ok=bool(cpu_ok))})
    if not cpu_ok:
        fail("the card's ERNIE-base logits disagree with the CPU run")
    del cpu_model, lg_cpu, nsp_cpu, lg_gpu, nsp_gpu

    model = model.to(torch.bfloat16)
    gen.manual_seed(SEED)  # the same request batches as the f32 pass
    rows_bf16, bf16_logits = run_batches(torch, pt, fa, model, "bfloat16",
                                         gen, keep)
    rel = ((bf16_logits - f32_logits).norm() / f32_logits.norm()).item()
    emit({"bf16_vs_f32": dict(batch=keep[0], seq=keep[1],
                              logits_rel_l2=rel, tol=5e-2,
                              ok=rel <= 5e-2)})
    if not rel <= 5e-2:
        fail(f"bf16 logits drift {rel} from f32 (relative L2 > 5e-2)")
    launches = fa.launches["flash_attn_fwd"]
    if launches == 0:
        fail("the main path launched no flash_attn_fwd kernel")
    return rows + rows_bf16, launches, launches_f32


def _ernie_loss(out, labels):
    from paddle_tpu_torch.models import ErnieForPretraining
    return ErnieForPretraining.pretraining_loss(out, labels)


def _train_batch(torch, vocab, b, s, device):
    """bench.py:102-105: ids and labels from numpy seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int64)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def _zero(fa):
    for k in fa.launches:
        fa.launches[k] = 0


def _gpt_lm_loss(out, labels):
    from paddle_tpu_torch.models import GPTForCausalLM
    return GPTForCausalLM.lm_loss(out, labels)


def _train_model(pt, kind, **kw):
    """ERNIE-base ("ernie", BASE) or GPT-2 small ("gpt", GPT_TRAIN) in
    train mode on the card, random weights from SEED; kw goes to the
    config (chunked_ce, scan_layers)."""
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         GPTConfig, GPTForCausalLM)
    pt.seed(SEED)
    if kind == "ernie_moe":
        kw = dict(MOE, **kw)
    if kind in ("ernie", "ernie_moe"):
        return ErnieForPretraining(ErnieConfig.base(**BASE, **kw),
                                   device="cuda").train()
    return GPTForCausalLM(GPTConfig(**GPT_TRAIN, **kw), device="cuda").train()


def _moe_loss(model):
    """examples/train_ernie_moe_longctx.py's loss: the pretraining loss
    plus aux_weight x the MoE layers' load-balancing loss."""
    cfg = model.config

    def loss(out, labels):
        return (_ernie_loss(out, labels)
                + cfg.moe_aux_weight * model.moe_aux_loss())
    return loss


def _train_step(torch, kind, model, amp_level="O1", **kw):
    """The phase's TrainStep of `model` on its path's batch (TRAIN_BATCH
    or GPT_TRAIN_BATCH, ids and labels from numpy seed 0): AdamW(1e-4,
    weight decay 0.01), AMP at amp_level in bf16 (O1; None: f32, no
    AMP), the dense loss or the chunked one; kw goes to TrainStep
    (remat, remat_policy). On the card it captures one CUDA graph at its
    first call and replays it after. Returns (step, x, y, (b, s),
    layers)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg = model.config
    chunked = cfg.chunked_ce
    if kind == "ernie_moe":
        (b, s), layers = MOE_BATCH, cfg.num_hidden_layers
        loss = _moe_loss(model)
    elif kind == "ernie":
        (b, s), layers = TRAIN_BATCH, cfg.num_hidden_layers
        loss = model.chunked_pretraining_loss if chunked else _ernie_loss
    else:
        (b, s), layers = GPT_TRAIN_BATCH, cfg.num_layers
        loss = model.chunked_lm_loss if chunked else _gpt_lm_loss
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, loss, opt, amp_level=amp_level,
                     amp_dtype="bfloat16", **kw)
    x, y = _train_batch(torch, cfg.vocab_size, b, s, "cuda")
    return step, x, y, (b, s), layers


def _expect_launches(kind, per_step, layers, fwd=1):
    """Every step launched fwd x layers forward kernels and layers of
    each backward kernel on the card (a warm-up's wrapper count,
    TrainStep.last_launches, or a replay's count on the device,
    profile_step)."""
    want = {k: layers * (fwd if k == "flash_attn_fwd" else 1)
            for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                      "flash_attn_bwd_dkv")}
    for i, c in enumerate(per_step):
        if c != want:
            fail(f"{kind} training step {i} launched {c}, expected {want}")


def _sum_launches(per_step):
    out = {}
    for c in per_step:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def _train_run(torch, fa, kind, model, warmup, steps, base):
    """warmup + steps TrainStep steps of `model` (_train_step): the first
    captures the step, the others replay it; then two replays under
    torch.profiler (profile_step, the row's `profile`). The kernels'
    counts are zeroed just before the first step. The first call's
    launches are its warm-up's, counted by the wrappers; a replay's are
    counted on the device in the profiled replays. Each must launch each
    kernel once per layer (_expect_launches); `launches` is their sum,
    `wrapper_counts` the wrappers' own counts (the warm-up's launches and
    the capture's, which records them once). Timed over the last `steps`
    on a synchronised host clock. base: the bytes allocated before the
    phase built its models (peak_above_base_bytes). Releases the step's
    graph before it returns the row."""
    step, x, y, (b, s), layers = _train_step(torch, kind, model)
    cfg = model.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa)
    losses = [step(x, y)]
    warm = dict(step.last_launches)
    for _ in range(warmup - 1):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    wrapper = dict(fa.launches)
    if not all(wrapper.values()):
        fail(f"{kind} training: a kernel's wrapper counted no launch: "
             f"{wrapper}")
    prof = profile_step(torch, step, x, y)
    per_step = [warm, prof["launches_per_replay"]]
    _expect_launches(kind, per_step, layers)
    if step.programs != 1 or step.recompile_sentinel.fired:
        fail(f"{kind} TrainStep captured {step.programs} programs with "
             f"{step.recompile_sentinel.fired} sentinel events, expected "
             "1 and 0")
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite {kind} training loss: {losses}")
    row = dict(model=kind, batch=b, seq=s, amp="O1 bfloat16",
               chunked_ce=bool(cfg.chunked_ce),
               scan_layers=bool(cfg.scan_layers), captured=True,
               graphs=step.programs, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               params=sum(p.numel() for p in model.parameters()),
               warmup_steps=warmup, timed_steps=steps,
               step_ms=secs / steps * 1e3, tokens_per_s=b * s * steps / secs,
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base,
               launches_per_step=prof["launches_per_replay"],
               launches=_sum_launches([warm, prof["kernel_launches"]]),
               counted_calls=COUNTED_CALLS, wrapper_counts=wrapper,
               losses=losses, profile=_profile_row(prof, top=25))
    step.release()
    return row


def train_flops_per_token(n_params, layers, hidden, seq):
    """bench.py's training FLOPs per token: 6N + 12 L h s (the attention
    term not halved for a causal mask)."""
    return 6.0 * n_params + 12.0 * layers * hidden * seq


def _with_mfu(row, layers, hidden, dtype="bfloat16"):
    """The row's FLOPs a token and its MFU against the peak rate of
    dtype (bf16's tensor cores, or FP32 outside them), named in
    mfu_peak."""
    row["flops_per_token"] = train_flops_per_token(row["params"], layers,
                                                   hidden, row["seq"])
    row["mfu"] = (row["tokens_per_s"] * row["flops_per_token"]
                  / PEAK_FLOPS[dtype])
    row["mfu_peak"] = f"{dtype} {PEAK_FLOPS[dtype]:.3g} FLOP/s"
    return row


def train_path(torch, pt, fa):
    """ERNIE-base pretraining through TrainStep on the card; its profiled
    replays make the `profile` line."""
    base = torch.cuda.memory_allocated()
    model = _train_model(pt, "ernie")
    row = _train_run(torch, fa, "ernie", model, TRAIN_WARMUP, TRAIN_STEPS,
                     base)
    cfg = model.config
    row["dropout"] = (cfg.hidden_dropout_prob,
                      cfg.attention_probs_dropout_prob)
    _with_mfu(row, cfg.num_hidden_layers, cfg.hidden_size)
    prof = row.pop("profile")
    emit({"train_path": row})
    emit({"profile": prof})
    losses, mfu = row["losses"], row["mfu"]
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall on a repeated batch: {losses}")
    if not 0 < mfu < 1:
        fail(f"MFU {mfu} is outside (0, 1)")
    return row


def train_cpu_check(torch, pt, fa, moe=False):
    """3 f32 TrainStep steps from the same weights on the card and on the
    CPU (plain path), 2 layers of the base width, dropout 0; with moe,
    ERNIE-base-MoE's (its second layer the expert mixture) and its
    loss."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg = ErnieConfig.base(**dict(BASE, num_hidden_layers=2),
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0,
                           **(MOE if moe else {}))
    pt.seed(SEED + 2)
    gm = ErnieForPretraining(cfg, device="cuda").train()
    cm = ErnieForPretraining(cfg, device="cpu").train()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    b, s = CPU_BATCH
    out = {}
    counts = {}
    for name, m, dev in (("card", gm, "cuda"), ("cpu", cm, "cpu")):
        st = TrainStep(m, _moe_loss(m) if moe else _ernie_loss,
                       AdamW(learning_rate=1e-3, weight_decay=0.01))
        x, y = _train_batch(torch, cfg.vocab_size, b, s, dev)
        _zero(fa)
        out[name], per_step = [], []
        for i in range(3):
            out[name].append(float(st(x, y)))
            if dev == "cpu" or i == 0:
                per_step.append(st.last_launches)
        if dev == "cuda":
            # the card's later steps are replays: count the kernels of
            # two more on the card
            per_step.append(profile_step(torch, st, x, y)["kernel_launches"])
            st.release()
        counts[name] = _sum_launches(per_step)
        del st
    rel = max(abs(a - c) / abs(c) for a, c in zip(out["card"], out["cpu"]))
    # the card ran the kernels (2 layers x 3 steps each), the CPU none
    ran = (all(v == 6 for v in counts["card"].values())
           and not any(counts["cpu"].values()))
    row = dict(layers=2, batch=b, seq=s, dtype="float32", moe=moe,
               losses_card=out["card"], losses_cpu=out["cpu"],
               launches=counts, max_rel_diff=rel, tol=1e-3,
               ok=rel <= 1e-3 and ran)
    emit({"moe_train_card_vs_cpu" if moe else "train_card_vs_cpu": row})
    if not row["ok"]:
        fail(f"the card's training losses disagree with the CPU's: {row}")
    return row


# kernel-name fragments of the profile's categories, first match wins
PROFILE_CATEGORIES = [
    ("flash attention kernels", ("fwd_wgmma", "fwd_ffma", "dq_wgmma",
                                 "dkv_wgmma", "dq_ffma", "dkv_ffma",
                                 "fwd_wg256", "dq_wg256", "dkv_wg256",
                                 "fwd_wgwide", "dq_wgwide", "dkv_wgwide",
                                 "fwd_wide", "dq_wide", "dkv_wide")),
    # cuDNN's convolution engines (implicit-GEMM fprop, dgrad, wgrad),
    # ahead of the matmuls, whose xmma/sm90_ fragments they share
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv",
                              "implicit_gemm", "implicit_convolve")),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "BatchNorm")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("embedding", ("embedding", "indexing_backward", "index")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "nchwToNhwc",
                          "nhwcToNchw")),
]


# the device kernels each wrapper launches, by the fragments of their
# names that torch.profiler shows (bf16 wgmma; f32 at 64 and 128 the
# FFMA kernels; at head_dim 256 the bf16 wg256 kernels; above it the
# bf16 wgwide kernels; from 256 the f32 wide FFMA kernels); no fragment
# is part of another wrapper's kernel names
KERNEL_EVENTS = {"flash_attn_fwd": ("fwd_wgmma", "fwd_ffma",
                                    "fwd_wg256", "fwd_wgwide", "fwd_wide"),
                 "flash_attn_bwd_dq": ("dq_wgmma", "dq_ffma", "dq_wg256",
                                       "dq_wgwide", "dq_wide"),
                 "flash_attn_bwd_dkv": ("dkv_wgmma", "dkv_ffma",
                                        "dkv_wg256", "dkv_wgwide",
                                        "dkv_wide")}
# what a training run's `launches` counts
COUNTED_CALLS = ("the first call's warm-up (the wrappers' count) and two "
                 "replays under torch.profiler (kernels counted on the "
                 "card, the largest count of PROFILE_ROUNDS rounds); the "
                 "timed replays run the same graph uncounted")


def kernel_launches(names):
    """Launches of each wrapper's kernels (KERNEL_EVENTS) among device
    event names, one name per launch."""
    out = {k: 0 for k in KERNEL_EVENTS}
    for name in names:
        for k, keys in KERNEL_EVENTS.items():
            if any(key in name for key in keys):
                out[k] += 1
                break
    return out


def is_nccl(name):
    """A device event of NCCL's: its collective kernels, and at one rank
    oneRankReduce, which an AVG all-reduce launches to scale by 1/1."""
    return "nccl" in name.lower() or "oneRankReduce" in name


def per_call(total, calls):
    """total launches over `calls` calls as launches a call; a count
    that does not divide stays a fraction, so it matches no whole
    expectation."""
    return {k: v // calls if v % calls == 0 else v / calls
            for k, v in total.items()}


# spin kernels launched ahead of each round's calls (device_profile's
# pad), and the name of torch.cuda._sleep's kernel. The profiler can
# lose the first device records of a window (9 in every unpadded round
# of PERF.md's call 13f, none in a round padded by 19 or more), which
# held a small step's first forward out of its count; a pad well above
# that loss leaves every kernel of the calls counted.
PROFILE_PAD = 64
PAD_KERNEL = "spin_kernel"
PROFILED_REPLAYS, PROFILE_ROUNDS = 2, 3


def device_profile(torch, fn, runs, pad=PROFILE_PAD, *, kernels=()):
    """torch.profiler over `runs` calls of fn (after one unprofiled
    call; with pad, that many empty spin kernels launched first inside
    the window, to take the records the profiler can lose at its start;
    their records are left out), per call:
    device ms, ms by PROFILE_CATEGORIES, device events,
    the top 25 by time; and over all runs: `kernel_launches`, the
    flash-attention kernels launched, and `device_events`, every device
    event (kernels, copies, sets; not the host ops that launched
    them), and `routes`, the launches of each kernel name of
    KERNEL_EVENTS (a wgmma or a SIMT route); with `kernels`, the
    launches of each device kernel name fragment in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [(ev.name, ev.time_range.elapsed_us() / 1e3)
              for ev in prof.events()
              if str(getattr(ev, "device_type", "")).endswith("CUDA")
              and PAD_KERNEL not in ev.name]
    by_name = {}
    for name, ev_ms in events:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + ev_ms / runs, calls + 1)
    rows = [(ms, name, calls // runs) for name, (ms, calls) in by_name.items()]
    rows.sort(reverse=True)
    cats = {}
    for ms, name, _ in rows:
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "other elementwise")
        cats[cat] = cats.get(cat, 0.0) + ms
    return dict(device_ms=sum(r[0] for r in rows), categories=cats,
                events=sum(r[2] for r in rows),
                top=[dict(ms=r[0], name=r[1][:90], calls=r[2])
                     for r in rows[:25]],
                kernel_launches=kernel_launches(n for n, _ in events),
                routes={key: sum(1 for n, _ in events if key in n)
                        for keys in KERNEL_EVENTS.values() for key in keys},
                nccl_launches=sum(1 for n, _ in events if is_nccl(n)),
                nccl_names=sorted({n[:90] for n, _ in events if is_nccl(n)}),
                device_events=len(events),
                **({"kernels": {k: sum(1 for n, _ in events if k in n)
                                for k in kernels}} if kernels else {}))


def max_counts(rounds):
    """Each kernel's largest count over the rounds' kernel_launches. The
    profiler drops a device record now and then (PERF.md §6, call 8i),
    which can only lower one round's count (and loses the first records
    of a window, which PROFILE_PAD takes); a graph that lost
    or doubled a kernel node moves it in every round."""
    return {k: max(r[k] for r in rounds) for k in rounds[0]}


def profile_calls(torch, fn, counter, runs=PROFILED_REPLAYS, kernels=()):
    """device_profile over `runs` calls of fn (a captured program's, whose
    replays `counter()` counts) in PROFILE_ROUNDS rounds. Fails unless
    every profiled call was a replay and the profiler saw device time
    inside them. Returns the round with the most device events, with
    each kernel's largest count over the rounds per call
    (`launches_per_replay`, `routes_per_replay`, and in
    `kernels_per_replay` each device kernel name of `kernels`)."""
    before = counter()
    rounds = [device_profile(torch, fn, runs, kernels=kernels)
              for _ in range(PROFILE_ROUNDS)]
    calls = PROFILE_ROUNDS * (runs + 1)
    if counter() - before != calls:
        fail(f"profile_calls: {counter() - before} of {calls} calls were "
             "replays")
    prof = max(rounds, key=lambda r: r["device_events"])
    if prof["device_ms"] <= 0:
        fail("torch.profiler saw no device time inside a replay")
    prof["kernel_launches"] = max_counts([r["kernel_launches"]
                                          for r in rounds])
    prof["routes"] = max_counts([r["routes"] for r in rounds])
    prof["device_events_by_round"] = [r["device_events"] for r in rounds]
    prof["launches_per_replay"] = per_call(prof["kernel_launches"], runs)
    prof["routes_per_replay"] = per_call(prof["routes"], runs)
    prof["kernels_per_replay"] = per_call(
        max_counts([r["kernels"] for r in rounds]), runs) if kernels else {}
    return prof


def profile_step(torch, step, x, y, runs=PROFILED_REPLAYS):
    """profile_calls over `runs` replays of a captured TrainStep: the
    profile is the round with the most device events,
    `launches_per_replay` the flash-attention kernels a replay ran,
    counted on the card (a replay does not pass through the wrappers;
    max_counts over the rounds), `routes_per_replay` the same by kernel
    name (KERNEL_EVENTS). Fails unless every profiled call was a
    replay, the profiler saw device time inside them and a replay ran
    the launches its capture recorded (TrainStep.capture_launches)."""
    prof = profile_calls(torch, lambda: step(x, y), lambda: step.replays,
                         runs)
    if prof["launches_per_replay"] != step.capture_launches:
        fail(f"a replay ran {prof['launches_per_replay']} kernels, its "
             f"capture recorded {step.capture_launches}")
    return prof


def _profile_row(prof, top=10):
    return dict(replays=PROFILED_REPLAYS,
                device_events_by_round=prof["device_events_by_round"],
                device_ms_per_step=prof["device_ms"],
                categories=prof["categories"], top=prof["top"][:top])


def _gpt_model(pt, device):
    """GPT-2 small (GPT2) in eval mode, random weights from SEED."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    pt.seed(SEED)
    return GPTForCausalLM(GPTConfig(**GPT2), device=device).eval()


def _median_ms(torch, fn, runs=5):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[runs // 2]


def causal_kernel_case(torch, fa, b, s, n, h, dt):
    """The causal forward kernel at the GPT forward's shape (q, k, v as
    strided views of a fused qkv tensor) against its plain version,
    timed beside SDPA's causal forward, with its bound."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    qkv = torch.randn((b, s, 3, n, h), generator=gen, device=dev,
                      dtype=torch.float32).to(getattr(torch, dt))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 1.0 / math.sqrt(h)
    o, lse = fa._flash_fwd_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, True, scale)
    err, ratio, ok = _row_err_ok(o, o_ref, dt)
    lse_err = (lse - lse_ref).abs().max().item()
    row = dict(dtype=dt, b=b, s=s, n=n, h=h, causal=True, dropout_p=0.0,
               max_abs_err=err, worst_row=ratio, tol=TOL[dt],
               lse_max_abs_err=lse_err,
               ok=bool(ok and lse_err <= TOL[dt]))
    if not row["ok"]:
        emit({"gpt_causal_kernel": row})
        fail(f"the causal flash_attn_fwd disagrees with its plain version: "
             f"{row}")
    row["ms"] = time_ms(lambda: fa._flash_fwd_cuda(q, k, v, True, scale),
                        reps=20)
    row["plain_ms"] = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, True, scale), reps=2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row["library_ms"] = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), reps=20)
    bound = fwd_bound(b, s, s, n, h, True, dt)
    row["bound_ms"], row["bound_by"] = bound["bound_ms"], bound["bound_by"]
    emit({"gpt_causal_kernel": row})
    del qkv, q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return row


def gpt_forward_phase(torch, pt, fa):
    """GPT-2 small's forward on the card in f32 and bf16: each forward
    must launch flash_attn_fwd (causal) once per layer and nothing else;
    the card against a CPU run of the same weights, bf16 against f32, and
    the causal kernel at every shape and dtype the forwards gave it.
    Returns (rows, kernel cases, the f32 model, launches per forward)."""
    import copy
    model = _gpt_model(pt, "cuda")
    layers, vocab = GPT2["num_layers"], GPT2["vocab_size"]
    models = {"float32": model,
              "bfloat16": copy.deepcopy(model).to(torch.bfloat16)}
    gen = torch.Generator(device="cuda")
    rows, kept = [], {}
    for dt, m in models.items():
        gen.manual_seed(SEED)   # the same request batches in both dtypes
        for b, s in GPT_BATCHES:
            ids = torch.randint(0, vocab, (b, s), generator=gen,
                                device="cuda")
            _zero(fa)
            with torch.no_grad():
                logits = m(ids)
            torch.cuda.synchronize()
            counts = dict(fa.launches)
            if counts != {**{k: 0 for k in counts}, "flash_attn_fwd": layers}:
                fail(f"GPT {dt} {b}x{s}: one forward launched {counts}, "
                     f"expected {layers} flash_attn_fwd and nothing else")
            if tuple(logits.shape) != (b, s, vocab):
                fail(f"GPT {dt} {b}x{s}: logits {tuple(logits.shape)}")
            if not torch.isfinite(logits).all():
                fail(f"GPT {dt} {b}x{s}: non-finite logits")
            if (b, s) == GPT_BATCHES[-1]:
                kept[dt] = logits.float().cpu()
            del logits
            with torch.no_grad():
                ms = _median_ms(torch, lambda: m(ids))
            row = dict(dtype=dt, batch=b, seq=s,
                       launches_per_forward=counts["flash_attn_fwd"],
                       latency_ms=ms, tokens_per_s=b * s / (ms / 1e3))
            emit({"gpt_forward": row})
            rows.append(row)
    del models["bfloat16"]
    rel = ((kept["bfloat16"] - kept["float32"]).norm()
           / kept["float32"].norm()).item()
    emit({"gpt_bf16_vs_f32": dict(batch=GPT_BATCHES[-1][0],
                                  seq=GPT_BATCHES[-1][1], logits_rel_l2=rel,
                                  tol=5e-2, ok=rel <= 5e-2)})
    if not rel <= 5e-2:
        fail(f"GPT bf16 logits drift {rel} from f32 (relative L2 > 5e-2)")

    b, s = CPU_BATCH
    g = torch.Generator().manual_seed(SEED + 1)
    ids = torch.randint(0, vocab, (b, s), generator=g)
    cpu_model = _gpt_model(pt, "cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    _zero(fa)
    with torch.no_grad():
        lg_cpu = cpu_model(ids)
        cpu_launches = fa.launches["flash_attn_fwd"]
        lg_gpu = model(ids.cuda()).cpu()
    err = (lg_gpu - lg_cpu).abs().max().item()
    ok = torch.allclose(lg_gpu, lg_cpu, atol=1e-3, rtol=1e-3) \
        and cpu_launches == 0
    emit({"gpt_card_vs_cpu": dict(batch=b, seq=s, dtype="float32",
                                  max_abs_err=err, tol=1e-3,
                                  cpu_launches=cpu_launches, ok=bool(ok))})
    if not ok:
        fail("the card's GPT-2 logits disagree with the CPU run")
    del cpu_model, lg_cpu, lg_gpu
    n, h = GPT2["num_heads"], GPT2["hidden_size"] // GPT2["num_heads"]
    cases = [causal_kernel_case(torch, fa, b, s, n, h, dt)
             for dt in ("float32", "bfloat16") for b, s in GPT_BATCHES]
    return rows, cases, model, rows[-1]["launches_per_forward"]


def _rel_gap(logits):
    """(top1 - top2) / |top1| of each row of f32 logits [..., V]."""
    top = logits.float().topk(2, dim=-1).values
    return ((top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp_min(
        1e-30)).cpu().numpy()


def streams_agree(got, want, gaps):
    """Token streams against their reference, one dict per stream:
    equal, or equal up to the first mismatch, where the reference's top-2
    logit gap (gaps, relative, per position) is below NEAR_TIE: a near
    tie that summation order on the card may flip. ok is False for any
    other mismatch."""
    out = []
    for g, w, gap in zip(got, want, gaps):
        g, w = list(map(int, g)), list(map(int, w))
        m = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 None if len(g) == len(w) else min(len(g), len(w)))
        row = dict(equal=m is None, first_mismatch=m)
        if m is not None:
            row["gap_rel"] = float(gap[m]) if m < len(gap) else None
            row["near_tie"] = row["gap_rel"] is not None and \
                row["gap_rel"] < NEAR_TIE
        row["ok"] = m is None or row["near_tie"]
        out.append(row)
    return out


def generate_phase(torch, pt, fa, model):
    """GPT-2 small generate() on the card: bf16 greedy at bench.py's
    shape, timed; then f32 greedy against argmax over a full re-forward
    (through the causal kernel) at every step."""
    import numpy as np
    vocab, layers = GPT2["vocab_size"], GPT2["num_layers"]
    b, p, n = GEN_SHAPE
    rng = np.random.RandomState(SEED)
    prompt = torch.from_numpy(
        rng.randint(0, vocab, (b, p)).astype(np.int64)).cuda()
    model.generate(prompt, max_new_tokens=n, dtype="bfloat16",
                   eager=True)                                   # warm
    torch.cuda.synchronize()
    _zero(fa)
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=n, dtype="bfloat16",
                         eager=True).cpu()
    secs = time.perf_counter() - t0
    launches = dict(fa.launches)
    if tuple(out.shape) != (b, p + n) or not torch.equal(
            out[:, :p].long(), prompt.cpu()) or not (
            (out >= 0) & (out < vocab)).all():
        fail(f"generate returned {tuple(out.shape)} or lost its prompt or "
             "left the vocabulary")
    row = dict(dtype="bfloat16", batch=b, prompt=p, new_tokens=n,
               seconds=secs, new_tokens_per_s=b * n / secs,
               ms_per_token=secs / n * 1e3, launches=launches)

    b2, p2, n2 = GEN_CHECK
    ids = torch.from_numpy(
        rng.randint(0, vocab, (b2, p2)).astype(np.int64)).cuda()
    got = model.generate(ids, max_new_tokens=n2,
                         eager=True).cpu().numpy()[:, p2:]
    _zero(fa)
    cur, want, gaps = ids, [], []
    with torch.no_grad():
        for _ in range(n2):
            last = model(cur)[:, -1].float()
            gaps.append(_rel_gap(last))
            nxt = last.argmax(-1)
            want.append(nxt.cpu().numpy())
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    torch.cuda.synchronize()
    reforward = fa.launches["flash_attn_fwd"]
    want, gaps = np.stack(want, 1), np.stack(gaps, 1)
    agree = streams_agree(got, want, gaps)
    row.update(check=dict(dtype="float32", batch=b2, prompt=p2,
                          new_tokens=n2, reforward_launches=reforward,
                          min_gap_rel=float(gaps.min()), streams=agree))
    emit({"generate": row})
    if reforward != n2 * layers:
        fail(f"the re-forwards launched {reforward} flash_attn_fwd, "
             f"expected {n2 * layers}")
    if not all(r["ok"] for r in agree):
        fail(f"f32 greedy generate differs from the full re-forward: {agree}")
    return row


def _program_inputs(np, rng, eng, name, shapes):
    """Random host inputs of one program key of `eng` (all tables drawn
    from distinct real pages, so every gather reads data)."""
    cfg, w, vocab = eng.config, eng.config.table_width, eng.vocab_size
    rows = shapes[0][0]
    perm = rng.permutation(np.arange(1, eng.cache.n_blocks))
    if name == "copy":
        return (perm[:1], perm[1:2])
    tables = perm[:rows * w].reshape(rows, w).astype(np.int32)
    if name in ("decode", "draft_decode"):
        steps = cfg.decode_chunk if name == "decode" else cfg.speculative_k
        return (tables, rng.randint(0, vocab, rows),
                rng.randint(0, cfg.max_total_tokens - steps, rows))
    s = shapes[1][1]
    ids = rng.randint(0, vocab, (rows, s))
    if name == "chunk":
        return (tables, ids, rng.randint(0, cfg.max_total_tokens - s + 1,
                                         rows), rng.randint(1, s + 1, rows))
    return (tables, ids, rng.randint(1, s + 1, rows))


def _program_fn(eng, name):
    """(program cache, function, cache, params) of a program name."""
    from paddle_tpu_torch.serving.programs import copy_page_fn
    if name == "copy":
        return eng.cache._copy, copy_page_fn, eng.cache, None
    if name.startswith("draft_"):
        fn = (eng._draft_decode_fn if name == "draft_decode"
              else eng._draft_prefill_fn)
        return eng.programs, fn, eng.draft_cache, eng.draft_params
    fn = {"decode": eng._decode_fn, "prefill": eng._prefill_fn,
          "chunk": eng._chunk_fn}[name]
    return eng.programs, fn, eng.cache, eng.params


def graph_vs_eager(torch, eng):
    """Each captured program of `eng` (the page copy and the draft's
    included) replayed against the same program run eagerly on the same
    inputs and Gumbel noise, from equal pools (filled with random K/V so
    every gather reads data): tokens and pools must come out equal. A
    chunk program's scratch page 0 is left out of the pool comparison:
    positions past a row's length write there from several lanes, and
    scratch is never read. The pools are zeroed afterwards."""
    import numpy as np
    from paddle_tpu_torch.models.generation import _gumbel
    rng = np.random.RandomState(SEED + 7)
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(SEED + 7)
    caches = [c for c in (eng.cache, eng.draft_cache) if c is not None]
    for c in caches:
        for kv in c.pools:
            for t in kv:
                t.normal_(generator=gen)
    keys = [("copy", k) for k in eng.cache._copy.keys()] + \
        [(k[0], k) for k in eng.programs.keys()]
    rows = []
    for name, key in keys:
        _, shapes, noise_shape = key
        progs, fn, cache, params = _program_fn(eng, name)
        inputs = _program_inputs(np, rng, eng, name, shapes)
        noise = (None if noise_shape is None
                 else _gumbel(noise_shape, gen, eng.device))
        eager_pools = tuple((k.clone(), v.clone()) for k, v in cache.pools)
        with torch.no_grad():
            want = fn(eager_pools, *[torch.from_numpy(
                np.asarray(a, np.int64)).cuda() for a in inputs],
                params, noise)
        got = progs(name, fn, cache.pools, params, inputs, noise)
        torch.cuda.synchronize()
        want = () if want is None else tuple(
            t.cpu().numpy() for t in (want if isinstance(want, tuple)
                                      else (want,)))
        got = () if got is None else (got if isinstance(got, tuple)
                                      else (got,))
        first = 1 if name == "chunk" else 0
        diff = max((a[first:].float() - b[first:].float()).abs().max().item()
                   for kv_a, kv_b in zip(cache.pools, eager_pools)
                   for a, b in zip(kv_a, kv_b))
        row = dict(program=name, shapes=[list(s_) for s_ in shapes],
                   noise=noise_shape is not None,
                   tokens_equal=len(got) == len(want) and all(
                       np.array_equal(a, b) for a, b in zip(got, want)),
                   pools_equal=diff == 0.0, pool_max_abs_diff=diff)
        emit({"graph_vs_eager": row})
        if not (row["tokens_equal"] and row["pools_equal"]):
            fail(f"a captured program disagrees with its eager run: {row}")
        rows.append(row)
        del eager_pools
    for c in caches:
        for kv in c.pools:
            for t in kv:
                t.zero_()
    torch.cuda.empty_cache()
    return rows


def serve_trace(np, vocab):
    """The staggered serving trace: SERVE_REQUESTS prompts of 8-128
    tokens and 16-128 new tokens from numpy seed SEED."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(8, 129, SERVE_REQUESTS)
    news = rng.randint(16, 129, SERVE_REQUESTS)
    prompts = [rng.randint(0, vocab, (int(n_),)).astype(np.int32)
               for n_ in lens]
    return prompts, [int(n_) for n_ in news]


def shared_prefix_trace(np, n, vocab, seed=SEED, prefix_len=SHARED_PREFIX,
                        frac=SHARED_FRAC, tails=SHARED_TAILS,
                        news=SHARED_NEW):
    """The shared-prefix traffic of paddle_tpu/serving/loadgen.py's
    synthetic_trace: one trace-wide prefix of prefix_len tokens, drawn
    first, prepended to a `frac` share of the requests' own tails (tails
    and new tokens uniform in the inclusive ranges). Returns (prompts,
    new tokens, which requests carry the prefix)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, (prefix_len,)).astype(np.int32)
    prompts, new, shared = [], [], []
    for _ in range(n):
        tail = rng.randint(0, vocab, (rng.randint(tails[0], tails[1] + 1),))
        new.append(int(rng.randint(news[0], news[1] + 1)))
        hit = bool(rng.rand() < frac)
        prompts.append(np.concatenate([prefix, tail]).astype(np.int32)
                       if hit else tail.astype(np.int32))
        shared.append(hit)
    return prompts, new, shared


def _run_trace(eng, prompts, news):
    """Submit the trace in waves of SERVE_WAVE every SERVE_EVERY engine
    steps and drain it. Returns (finished requests by rid, seconds,
    steps, the peak of the cache's live pages)."""
    done, submitted, steps, peak = [], 0, 0, 0
    n = len(prompts)
    t0 = time.perf_counter()
    while submitted < n or eng.has_work():
        if steps % SERVE_EVERY == 0 and submitted < n:
            for i in range(submitted, min(submitted + SERVE_WAVE, n)):
                eng.submit(prompts[i], int(news[i]), rid=i)
            submitted = min(submitted + SERVE_WAVE, n)
        done.extend(eng.step())
        peak = max(peak, eng.cache.n_live)
        steps += 1
        if steps > 20000:
            fail("a serving trace did not drain")
    return {r.rid: r for r in done}, time.perf_counter() - t0, steps, peak


def _check_streams(what, by_rid, news, vocab):
    bad = [i for i in range(len(news))
           if i not in by_rid or len(by_rid[i].out) != int(news[i])
           or not all(0 <= t < vocab for t in by_rid[i].out)]
    if bad:
        fail(f"{what}: requests {bad} came out short or out of the vocab")


def serving_phase(torch, pt, fa, model):
    """The bf16 ServingEngine at SERVE_CONFIG on GPT-2 small: warm-up
    (captures one CUDA graph per bucket), each graph against its eager
    run, then a staggered trace of SERVE_REQUESTS requests. Returns the
    row and the streams by rid."""
    import numpy as np
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    vocab = GPT2["vocab_size"]
    eng = ServingEngine(model, ServingConfig(**SERVE_CONFIG))
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    captures = eng.programs.captures
    checks = graph_vs_eager(torch, eng)

    prompts, news = serve_trace(np, vocab)
    progs = eng.programs
    eager0, replays0 = progs.eager_dispatches, progs.replays
    progs.dispatch_ms.clear()    # the trace's dispatches only
    _zero(fa)
    by_rid, secs, steps, _ = _run_trace(eng, prompts, news)
    launches = dict(fa.launches)
    done = list(by_rid.values())
    tokens = sum(len(r.out) for r in done)
    ttft = np.array([(r.first_token_ts - r.arrival) * 1e3 for r in done])
    dec, pre = progs.dispatch_ms["decode"], progs.dispatch_ms["prefill"]
    # the device time of one decode replay at the largest bucket, against
    # the host time of a dispatch (copy in, replay, copy out)
    big = next(k for k in progs.keys()
               if k[0] == "decode" and k[1][0][0] == max(
                   SERVE_CONFIG["decode_buckets"]))
    replay = progs.graph(big).graph.replay
    replay_ms = time_ms(replay, reps=20)
    emit({"serving_profile": dict(
        program="decode", bucket=big[1][0][0],
        token_boundaries=SERVE_CONFIG["decode_chunk"],
        per_replay=device_profile(torch, replay, runs=3))})
    row = dict(
        dtype="bfloat16", config=SERVE_CONFIG, requests=len(done),
        steps=steps, seconds=secs, generated_tokens=tokens,
        tokens_per_s=tokens / secs,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p99=float(np.percentile(ttft, 99)),
        decode_dispatch_ms_p50=float(np.percentile(dec, 50)),
        prefill_dispatch_ms_p50=float(np.percentile(pre, 50)),
        decode_dispatches=len(dec), prefill_dispatches=len(pre),
        decode_dispatch_ms_sum=float(np.sum(dec)),
        prefill_dispatch_ms_sum=float(np.sum(pre)),
        decode_replay_device_ms=replay_ms,
        warmup_seconds=warm_s, graphs_captured=captures,
        graphs_after_trace=progs.captures,
        executable_count=eng.executable_count(),
        expected_executables=eng.expected_executables,
        sentinel_fired=eng.sentinel.fired,
        eager_dispatches_after_warmup=progs.eager_dispatches - eager0,
        replays=progs.replays - replays0,
        pages_free=eng.cache.n_free, n_blocks=eng.cache.n_blocks,
        pool_bytes=eng.cache.pool_bytes, launches=launches,
        graph_vs_eager=len(checks))
    row["invariants"] = eng.cache.check_invariants()
    emit({"serving": row})
    _check_streams("serving", by_rid, news, vocab)
    if not (row["executable_count"] == row["expected_executables"]
            == captures == progs.captures):
        fail(f"serving programs {row['executable_count']}, graphs "
             f"{progs.captures}, expected {row['expected_executables']}")
    if row["sentinel_fired"] or row["eager_dispatches_after_warmup"]:
        fail(f"serving sentinel fired {row['sentinel_fired']} times, "
             f"{row['eager_dispatches_after_warmup']} eager dispatches")
    if row["pages_free"] != eng.cache.n_blocks - 1:
        fail(f"{row['pages_free']} pages free at the end, expected "
             f"{eng.cache.n_blocks - 1}")
    return row, {i: list(r.out) for i, r in by_rid.items()}


def _staggered(eng, prompts, news):
    """r0 alone, r1 two boundaries later, r2 and r3 at the next, r4 and
    r5 at the one after; drained. Returns the streams in that order."""
    rids = [eng.submit(prompts[0], news[0])]
    eng.step()
    eng.step()
    rids.append(eng.submit(prompts[1], news[1]))
    eng.step()
    rids += [eng.submit(prompts[i], news[i]) for i in (2, 3)]
    eng.step()
    rids += [eng.submit(prompts[i], news[i]) for i in (4, 5)]
    by_rid = {r.rid: r for r in eng.run_to_completion()}
    return [by_rid[rid].out for rid in rids]


def _stream_gaps(torch, model, prompt, stream):
    """The relative top-2 gap of the f32 logits at each position of
    `stream` after `prompt` (one full forward, through the causal
    kernel)."""
    import numpy as np
    ids = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
    with torch.no_grad():
        lg = model(torch.from_numpy(ids[None].astype(np.int64)).cuda())
    return _rel_gap(lg[0, len(prompt) - 1:])


def serving_parity_phase(torch, pt, fa, model):
    """The f32 engine (dtype=None) under staggered admission: each stream
    against the port's solo greedy generate() of the same prompt, with the
    near-tie rule of streams_agree (the reference's gaps from a full
    forward of its own stream). Returns the engine (drained), the
    prompts, new tokens, the solo streams and their gaps, for the lever
    phase's f32 checks."""
    import numpy as np
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    vocab = GPT2["vocab_size"]
    eng = ServingEngine(model, ServingConfig(**dict(SERVE_CONFIG,
                                                    dtype=None))).warmup()
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, vocab, (n_,)).astype(np.int32)
               for n_, _ in PARITY_SPECS]
    news = [n_ for _, n_ in PARITY_SPECS]
    got = _staggered(eng, prompts, news)
    want, gaps = [], []
    for p, n_ in zip(prompts, news):
        ids = torch.from_numpy(p[None].astype(np.int64)).cuda()
        solo = model.generate(ids, max_new_tokens=n_,
                              eager=True)[0, len(p):]
        want.append(solo.cpu().numpy())
        gaps.append(_stream_gaps(torch, model, p, want[-1]))
    agree = streams_agree(got, want, gaps)
    row = dict(dtype="float32", requests=len(got), specs=PARITY_SPECS,
               streams=agree, exact=all(r["equal"] for r in agree),
               min_gap_rel=float(min(g.min() for g in gaps)),
               executable_count=eng.executable_count(),
               expected_executables=eng.expected_executables,
               sentinel_fired=eng.sentinel.fired,
               eager_dispatches=eng.programs.eager_dispatches,
               pages_free=eng.cache.n_free,
               invariants=eng.cache.check_invariants())
    emit({"serving_parity": row})
    if not all(r["ok"] for r in agree):
        fail(f"f32 engine streams differ from solo generate: {agree}")
    if (row["executable_count"] != row["expected_executables"]
            or row["sentinel_fired"] or row["eager_dispatches"]
            or row["pages_free"] != eng.cache.n_blocks - 1):
        fail(f"f32 engine contract broken: {row}")
    return dict(engine=eng, prompts=prompts, news=news, want=want,
                gaps=gaps)


def int8_acc_plain(torch, codes, q8):
    """The plain version of int8_gemm: codes [M, K] x q8 [K, N] in
    float64, exact while every partial sum fits float64's 53-bit
    significand: |acc| <= 128 * 128 * K < 2**53."""
    k = codes.shape[-1]
    if 128 * 128 * k >= 2 ** 53:
        raise ValueError(f"K={k}: float64 cannot hold the accumulator "
                         "exactly")
    return codes.double() @ q8.double()


def int8_bound(m, k, n):
    """(bytes, int8 operations, bound ms, bound by) of int8_matmul over
    x [m, k] bf16 and q8 [k, n]: x, the codes, the scales and the bf16
    output moved once; 2 m k n int8 operations."""
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    ops = 2 * m * k * n
    return (nbytes, ops) + _bound(nbytes, ops, "int8")


def int8_matmul_phase(torch, model):
    """int8_matmul at every block matmul of GPT-2 small (block 0's
    weights, quantized) on INT8_ROWS rows of bf16 activations: the int32
    accumulators of int8_gemm must equal int8_acc_plain's and the output
    the plain rescale of them, bit for bit. Timed beside the plain
    version and a bf16 matmul of the float weight (the library
    yardstick); then _int_mm with the codes column-major (as stored)
    against row-major (`int8_layout`)."""
    from paddle_tpu_torch.quant import (int8_gemm, int8_matmul,
                                        quantize_activation, quantize_weight)
    blk = model.gpt.blocks[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    rows = []
    for name in ("qkv", "proj", "fc1", "fc2"):
        w = getattr(blk, name).weight.detach()
        leaf = quantize_weight(w)
        q8, s = leaf["q8"], leaf["s"]
        wb = w.to(torch.bfloat16)
        k, n = w.shape
        for m in INT8_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            codes, sx = quantize_activation(x)
            acc = int8_gemm(codes, q8)
            plain = int8_acc_plain(torch, codes, q8)
            out = int8_matmul(x, q8, s)
            out_plain = (plain.float() * sx * s).to(x.dtype)
            nbytes, ops, bound_ms, bound_by = int8_bound(m, k, n)
            row = dict(matmul=name, rows=m, k=k, n=n,
                       acc_equal=bool(torch.equal(acc.double(), plain)),
                       out_equal=bool(torch.equal(out, out_plain)),
                       max_abs_err=(out.float() - out_plain.float()).abs()
                       .max().item(), bytes=nbytes, int8_ops=ops,
                       bound_ms=bound_ms, bound_by=bound_by)
            if not (row["acc_equal"] and row["out_equal"]):
                emit({"int8_matmul": row})
                fail(f"int8_matmul disagrees with its plain version: {row}")

            def plain_fn():
                c, f = quantize_activation(x)
                return (int8_acc_plain(torch, c, q8).float() * f
                        * s).to(x.dtype)
            row["ms"] = time_ms(lambda: int8_matmul(x, q8, s), reps=50)
            row["plain_ms"] = time_ms(plain_fn, reps=5)
            row["library_ms"] = time_ms(lambda: x @ wb, reps=50)
            emit({"int8_matmul": row})
            rows.append(row)
    x = torch.randint(-128, 128, (INT8_ROWS[-1], q8.shape[0]),
                      generator=gen, device="cuda", dtype=torch.int8)
    emit({"int8_layout": dict(
        matmul="fc2", rows=INT8_ROWS[-1], k=q8.shape[0], n=q8.shape[1],
        column_major_ms=time_ms(lambda: torch._int_mm(x, q8), reps=50),
        row_major_ms=time_ms(lambda: torch._int_mm(
            x, q8.contiguous()), reps=50))})
    return rows


def _lever_engine(torch, model, draft=None, **kw):
    """A warmed ServingEngine at SERVE_CONFIG with `kw` on top; returns
    it and its warm-up seconds."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    eng = ServingEngine(model, ServingConfig(**dict(SERVE_CONFIG, **kw)),
                        draft_model=draft)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _lever_trace(torch, fa, eng, prompts, news, what):
    """One trace through a warmed lever engine, and the contract every
    lever engine keeps: streams of the asked length in the vocab, graphs
    = programs = expected, no sentinel event, no eager dispatch, every
    page back (free, or held by the prefix index alone) and the cache
    invariants. Returns the row and the streams by rid."""
    import numpy as np
    progs, copy = eng.programs, eng.cache._copy
    eager0 = progs.eager_dispatches + copy.eager_dispatches
    prop0, acc0 = eng.spec_proposed, eng.spec_accepted
    progs.dispatch_ms.clear()
    _zero(fa)
    by_rid, secs, steps, peak = _run_trace(eng, prompts, news)
    done = list(by_rid.values())
    tokens = sum(len(r.out) for r in done)
    ttft = np.array([(r.first_token_ts - r.arrival) * 1e3 for r in done])
    cache = eng.cache
    row = dict(
        requests=len(done), steps=steps, seconds=secs,
        generated_tokens=tokens, tokens_per_s=tokens / secs,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p99=float(np.percentile(ttft, 99)),
        dispatch_ms_p50={k: float(np.percentile(v, 50))
                         for k, v in progs.dispatch_ms.items()},
        dispatches={k: len(v) for k, v in progs.dispatch_ms.items()},
        graphs=progs.captures + copy.captures,
        executable_count=eng.executable_count(),
        expected_executables=eng.expected_executables,
        sentinel_fired=eng.sentinel.fired,
        eager_dispatches_after_warmup=(progs.eager_dispatches
                                       + copy.eager_dispatches - eager0),
        launches=dict(fa.launches), peak_pages_live=peak,
        pages_available=cache.available_pages, n_blocks=cache.n_blocks,
        live_requests=len(cache.live_requests()),
        invariants=cache.check_invariants())
    if eng.draft_cache is not None:
        row.update(draft_pages_free=eng.draft_cache.n_free,
                   draft_invariants=eng.draft_cache.check_invariants())
    if eng.config.speculative_k:
        prop, acc = eng.spec_proposed - prop0, eng.spec_accepted - acc0
        row.update(proposed=prop, accepted=acc,
                   acceptance_rate=acc / prop if prop else None)
    if cache.prefix_sharing:
        st = cache.stats()
        row.update({k: st[k] for k in (
            "prefix_hits", "shared_pages_matched", "pages_shared",
            "cow_copies", "reclaimed_pages", "prefix_nodes")})
    _check_streams(what, by_rid, news, eng.vocab_size)
    if not (row["executable_count"] == row["expected_executables"]
            == row["graphs"]):
        fail(f"{what}: programs {row['executable_count']}, graphs "
             f"{row['graphs']}, expected {row['expected_executables']}")
    if row["sentinel_fired"] or row["eager_dispatches_after_warmup"]:
        fail(f"{what}: sentinel fired {row['sentinel_fired']} times, "
             f"{row['eager_dispatches_after_warmup']} eager dispatches")
    if row["pages_available"] != cache.n_blocks - 1 or row["live_requests"]:
        fail(f"{what}: {row['pages_available']} pages back of "
             f"{cache.n_blocks - 1}, {row['live_requests']} requests live")
    if eng.draft_cache is not None and \
            row["draft_pages_free"] != eng.draft_cache.n_blocks - 1:
        fail(f"{what}: the draft cache kept pages: {row}")
    return row, {i: list(r.out) for i, r in by_rid.items()}


def _parity_row(eng, agree):
    return dict(streams=agree, exact=all(r["equal"] for r in agree),
                executable_count=eng.executable_count(),
                expected_executables=eng.expected_executables,
                sentinel_fired=eng.sentinel.fired,
                eager_dispatches=(eng.programs.eager_dispatches
                                  + eng.cache._copy.eager_dispatches),
                pages_available=eng.cache.available_pages,
                invariants=eng.cache.check_invariants())


def _parity_gates(what, eng, row):
    if not all(r["ok"] for r in row["streams"]):
        fail(f"{what}: f32 streams differ from their reference: {row}")
    if (row["executable_count"] != row["expected_executables"]
            or row["sentinel_fired"] or row["eager_dispatches"]
            or row["pages_available"] != eng.cache.n_blocks - 1):
        fail(f"{what}: f32 engine contract broken: {row}")


def lever_int8(torch, pt, fa, model, bf16_streams):
    """(a) int8: int8_matmul against its plain version, the logits-drift
    receipt, and the bf16+int8 engine over the serving trace against the
    bf16 engine's streams."""
    import numpy as np
    from paddle_tpu_torch.models.generation import _gpt_params
    from paddle_tpu_torch.quant import logits_drift_receipt
    vocab = GPT2["vocab_size"]
    cases = int8_matmul_phase(torch, model)
    ids = torch.from_numpy(np.random.RandomState(SEED + 12).randint(
        0, vocab, INT8_DRIFT)).cuda()
    drift = logits_drift_receipt(_gpt_params(model),
                                 model.gpt.config.layer_norm_eps,
                                 GPT2["num_heads"], ids)
    if not all(math.isfinite(v) for v in drift.values()):
        fail(f"int8 logits drift is not finite: {drift}")
    eng, warm = _lever_engine(torch, model, quant="int8")
    checks = graph_vs_eager(torch, eng)
    prompts, news = serve_trace(np, vocab)
    row, streams = _lever_trace(torch, fa, eng, prompts, news, "int8")
    same = sum(a == b for i in streams
               for a, b in zip(streams[i], bf16_streams[i]))
    total = sum(len(v) for v in streams.values())
    row.update(lever="int8", dtype="bfloat16", quant="int8",
               warmup_seconds=warm, graph_vs_eager=len(checks),
               token_agreement_with_bf16=same / total,
               streams_equal_to_bf16=sum(streams[i] == bf16_streams[i]
                                         for i in streams),
               drift=dict(drift, prompts=INT8_DRIFT[0],
                          tokens=INT8_DRIFT[1]),
               int8_matmul_cases=len(cases))
    emit({"serving_levers": row})
    del eng
    torch.cuda.empty_cache()
    return row


def lever_speculative(torch, pt, fa, model, parity):
    """(b) speculative decoding at k = LEVER_K with DRAFT: f32 streams of
    the parity requests against non-speculative greedy (solo generate,
    near-tie rule), then the bf16 serving trace with that draft and
    with a draft equal to the target."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    pt.seed(SEED + 1)
    draft = GPTForCausalLM(GPTConfig(**DRAFT), device="cuda").eval()
    eng, _ = _lever_engine(torch, model, draft, dtype=None,
                           speculative_k=LEVER_K)
    got = _staggered(eng, parity["prompts"], parity["news"])
    par = _parity_row(eng, streams_agree(got, parity["want"],
                                         parity["gaps"]))
    par.update(proposed=eng.spec_proposed, accepted=eng.spec_accepted)
    _parity_gates("speculative", eng, par)
    del eng
    prompts, news = serve_trace(np, GPT2["vocab_size"])
    runs = {}
    for name, d in (("distinct_draft", draft), ("draft_is_target", model)):
        eng, warm = _lever_engine(torch, model, d, speculative_k=LEVER_K)
        checks = graph_vs_eager(torch, eng) if not runs else []
        runs[name], _ = _lever_trace(torch, fa, eng, prompts, news,
                                     f"speculative {name}")
        runs[name].update(warmup_seconds=warm, graph_vs_eager=len(checks))
        del eng
        torch.cuda.empty_cache()
    row = dict(lever="speculative", dtype="bfloat16", k=LEVER_K,
               draft={k: DRAFT[k] for k in ("vocab_size", "hidden_size",
                                            "num_heads", "num_layers")},
               parity_f32=par, **runs)
    emit({"serving_levers": row})
    rate = runs["draft_is_target"]["acceptance_rate"]
    if rate is None or rate < 0.5:
        fail(f"a draft equal to the target accepted {rate} of its "
             "proposals (a near-tie flip aside, all should land)")
    del draft
    return row


def lever_prefix(torch, pt, fa, model, parity):
    """(c) prefix sharing: f32 streams of staggered shared-prefix
    requests against the unshared f32 engine's, then the bf16
    shared-prefix trace on the sharing engine and on the unshared one."""
    import numpy as np
    vocab = GPT2["vocab_size"]
    rng = np.random.RandomState(SEED + 3)
    head = rng.randint(0, vocab, (SHARED_PREFIX,)).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(0, vocab, (t,)).astype(
        np.int32)]) for t, _ in SHARED_PARITY]
    news = [n_ for _, n_ in SHARED_PARITY]
    want = _staggered(parity["engine"], prompts, news)
    gaps = [_stream_gaps(torch, model, p, w) for p, w in zip(prompts, want)]
    eng, _ = _lever_engine(torch, model, dtype=None, prefix_sharing=True)
    got = _staggered(eng, prompts, news)
    par = _parity_row(eng, streams_agree(got, want, gaps))
    par.update(prefix_hits=eng.cache.prefix_hits,
               shared_pages_matched=eng.cache.shared_pages_matched)
    _parity_gates("prefix sharing", eng, par)
    if not par["prefix_hits"]:
        fail(f"the f32 sharing engine matched no prefix: {par}")
    del eng, parity["engine"]
    torch.cuda.empty_cache()
    sp, sn, hit = shared_prefix_trace(np, SERVE_REQUESTS, vocab)
    eng, _ = _lever_engine(torch, model)
    unshared, _ = _lever_trace(torch, fa, eng, sp, sn, "unshared")
    del eng
    eng, warm = _lever_engine(torch, model, prefix_sharing=True)
    checks = graph_vs_eager(torch, eng)
    shared, _ = _lever_trace(torch, fa, eng, sp, sn, "prefix sharing")
    shared.update(warmup_seconds=warm, graph_vs_eager=len(checks))
    del eng
    torch.cuda.empty_cache()
    row = dict(lever="prefix_sharing", dtype="bfloat16",
               trace=dict(requests=len(sp), prefix=SHARED_PREFIX,
                          with_prefix=sum(hit), tails=SHARED_TAILS,
                          new_tokens=SHARED_NEW),
               parity_f32=par, shared=shared, unshared=unshared)
    emit({"serving_levers": row})
    if not shared["prefix_hits"]:
        fail("the bf16 sharing engine matched no prefix")
    if not shared["peak_pages_live"] < unshared["peak_pages_live"]:
        fail(f"sharing held {shared['peak_pages_live']} pages at its "
             f"peak, the unshared engine {unshared['peak_pages_live']}")
    return row


def lever_sampling(torch, pt, fa, model):
    """(d) sampling inside the captured graphs: the bf16 engine at
    SAMPLING, twice from one seed over the serving trace (streams equal);
    every program, the sampled prefill and decode and (with prefix
    sharing) the sampled chunk, bit-equal to eager on the same noise."""
    import numpy as np
    prompts, news = serve_trace(np, GPT2["vocab_size"])
    runs, streams = [], []
    for _ in range(2):
        eng, warm = _lever_engine(torch, model, seed=SEED, **SAMPLING)
        r, st = _lever_trace(torch, fa, eng, prompts, news, "sampling")
        r["warmup_seconds"] = warm
        runs.append(r)
        streams.append(st)
    checks = graph_vs_eager(torch, eng)
    del eng
    eng, _ = _lever_engine(torch, model, seed=SEED, prefix_sharing=True,
                           **SAMPLING)
    checks += graph_vs_eager(torch, eng)
    del eng
    torch.cuda.empty_cache()
    row = dict(lever="sampling", dtype="bfloat16", **SAMPLING, seed=SEED,
               runs=runs, streams_identical=streams[0] == streams[1],
               graph_vs_eager=[(c["program"], c["noise"]) for c in checks])
    emit({"serving_levers": row})
    if not row["streams_identical"]:
        fail("two sampled runs from one seed gave different streams")
    if not any(c["program"] == "chunk" and c["noise"] for c in checks):
        fail("no sampled chunk program was held against its eager run")
    return row


def serving_levers_phase(torch, pt, fa, model, bf16_streams, parity):
    """The serving raw-speed levers on GPT-2 small, one JSON line each:
    int8, speculative decoding, prefix sharing, sampling."""
    t0 = time.perf_counter()
    lever_int8(torch, pt, fa, model, bf16_streams)
    lever_speculative(torch, pt, fa, model, parity)
    lever_prefix(torch, pt, fa, model, parity)
    lever_sampling(torch, pt, fa, model)
    emit({"serving_levers_seconds": time.perf_counter() - t0})


# -- captured generate (item 10e) and the telemetry planes (item 16) ---------
# generate's modes at GEN_SHAPE: (name, generate() keywords); ragged's
# prompt lengths and beam's eos are filled in by generate_capture_phase
GEN_MODES = [("greedy", {}),
             ("top_k", dict(temperature=0.8, top_k=50)),
             ("top_p", dict(temperature=0.8, top_p=0.9)),
             ("top_k_top_p", dict(temperature=0.8, top_k=50, top_p=0.9)),
             ("ragged", {}), ("beam", dict(num_beams=4))]
GEN_SEED = 5


def generate_capture_gates(rows):
    """Failures of the generate_capture rows: captured tokens not
    bit-equal to eager, a sampled mode whose call at a second seed
    through the same program was not bit-equal to eager at that seed or
    repeated the first seed's tokens (or was not made), a second call of
    a seen signature that captured, a sentinel event, a program count
    off the signatures seen."""
    bad = []
    for r in rows:
        what = f"generate_capture {r['mode']} {r['dtype']}"
        if not r["bit_equal"]:
            bad.append(f"{what}: captured tokens differ from eager")
        if r.get("sampled"):
            if r.get("other_seed_bit_equal") is not True:
                bad.append(f"{what}: at the second seed the captured "
                           f"tokens differ from eager (or were not held)")
            if r.get("other_seed_differs") is not True:
                bad.append(f"{what}: the second seed repeated the first "
                           f"seed's tokens (or was not run)")
        if r["second_call_captures"]:
            bad.append(f"{what}: a second call with the same signature "
                       f"captured {r['second_call_captures']} programs")
        if r["sentinel_events"]:
            bad.append(f"{what}: {r['sentinel_events']} sentinel events")
        if r["graphs"] != r["expected_graphs"]:
            bad.append(f"{what}: {r['graphs']} programs, expected "
                       f"{r['expected_graphs']}")
    return bad


def _gen_call(torch, model, ids, kw, eager):
    """(tokens on the card, host seconds) of one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, eager=eager, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def generate_capture_phase(torch, pt, model):
    """Captured generate on GPT-2 small at GEN_CAPTURE_SHAPE, each mode of
    GEN_MODES in bf16 and f32: the first call captures the signature's
    programs (prefill, step, finish), a second call replays them and is
    held bit-equal to the eager loop (eager=True) from the same seed,
    captures nothing and fires no sentinel. Timed: captured and eager ms
    a token from the same call; under torch.profiler the device ms of a
    whole captured call and of its prefill graph, hence of one decode
    step, and the idle share of the call. Then f32 greedy captured
    against argmax over a full re-forward (GEN_CHECK, near-tie rule)."""
    import numpy as np
    from paddle_tpu_torch.models.generation import generate_programs
    vocab = GPT2["vocab_size"]
    b, p, n = GEN_CAPTURE_SHAPE
    rng = np.random.RandomState(SEED + 9)
    ids = torch.from_numpy(rng.randint(0, vocab, (b, p))).cuda()
    lens = torch.from_numpy(rng.randint(1, p + 1, b))
    st = generate_programs(model)
    st.release()
    card = nvidia_smi()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    rows, seen = [], set()
    eos = None
    for name, kw in GEN_MODES:
        kw = dict(kw, max_new_tokens=n, seed=GEN_SEED)
        if name == "ragged":
            kw["prompt_lens"] = lens
        if name == "beam":
            kw["eos_token_id"] = eos
        for dt in ("bfloat16", None):
            kw["dtype"] = dt
            first, first_s = _gen_call(torch, model, ids, kw, None)
            if name == "greedy" and dt == "bfloat16":
                # the token greedy picks first for row 0: the beam mode's
                # eos, so a finished beam freezes at its first step
                eos = int(first[0, p])
            captures = st.captures
            got, cap_s = _gen_call(torch, model, ids, kw, None)
            second = st.captures - captures
            want, eager_s = _gen_call(torch, model, ids, kw, True)
            sampled = bool(kw.get("temperature"))
            other = {}
            if sampled:
                # a second seed through the same program: it must reach
                # the generator registered with the graphs
                okw = dict(kw, seed=GEN_SEED + 1)
                captures = st.captures
                o_got, _ = _gen_call(torch, model, ids, okw, None)
                second += st.captures - captures
                o_want, _ = _gen_call(torch, model, ids, okw, True)
                other = dict(other_seed=GEN_SEED + 1,
                             other_seed_bit_equal=bool(
                                 torch.equal(o_got, o_want)),
                             other_seed_differs=not torch.equal(o_got,
                                                                want))
            seen.add((name, dt))
            row = dict(card=card, mode=name, dtype=dt or "float32",
                       batch=b, prompt=p,
                       new_tokens=n,
                       bit_equal=bool(torch.equal(got, want)
                                      and torch.equal(first, want)),
                       first_call_s=first_s,
                       captured_ms_per_token=cap_s / n * 1e3,
                       eager_ms_per_token=eager_s / n * 1e3,
                       speedup=eager_s / cap_s,
                       sampled=sampled, **other,
                       second_call_captures=second,
                       graphs=st.programs, expected_graphs=len(seen),
                       sentinel_events=st.sentinel.fired,
                       generate_args={k: v for k, v in kw.items()
                                      if k != "prompt_lens"})
            if dt == "bfloat16":
                prog = st.last
                call = device_profile(
                    torch, lambda: model.generate(ids, **kw), runs=1)
                pre = device_profile(torch, prog.graphs["prefill"].replay,
                                     runs=3)
                fin = device_profile(torch, prog.graphs["finish"].replay,
                                     runs=3)
                step_ms = (call["device_ms"] - pre["device_ms"]
                           - fin["device_ms"]) / (n - 1)
                row.update(
                    call_device_ms=call["device_ms"],
                    call_host_ms=cap_s * 1e3,
                    idle_share=1.0 - call["device_ms"] / (cap_s * 1e3),
                    prefill_device_ms=pre["device_ms"],
                    decode_step_device_ms=step_ms,
                    decode_step_kernels=(call["events"] - pre["events"]
                                         - fin["events"]) / (n - 1),
                    call_categories=call["categories"],
                    top=call["top"][:8])
            emit({"generate_capture": row})
            rows.append(row)
    bad = generate_capture_gates(rows)
    # what the resident programs hold: their static buffers (KV caches
    # and state), the bf16 weight copies, and the graphs' shared pool
    # (reserved beyond allocated once the free cache is emptied)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    cast = sum(x.numel() * x.element_size() for w in st.weights.values()
               for x, owned in zip(w._own, w.owned) if owned)
    emit({"generate_capture_memory": dict(
        card=card, programs=st.programs, program_bytes=st.runs.nbytes,
        program_bytes_max=st.runs.max_bytes, evictions=st.runs.evictions,
        cast_weight_bytes=cast, allocated_before=mem0[0],
        allocated_after=mem1[0], reserved_before=mem0[1],
        reserved_after=mem1[1],
        allocated_beyond_buffers=mem1[0] - mem0[0] - st.runs.nbytes - cast,
        reserved_beyond_allocated=(mem1[1] - mem1[0]) - (mem0[1] - mem0[0]))})

    b2, p2, n2 = GEN_CHECK
    ids2 = torch.from_numpy(rng.randint(0, vocab, (b2, p2))).cuda()
    got = model.generate(ids2, max_new_tokens=n2).cpu().numpy()[:, p2:]
    cur, want, gaps = ids2, [], []
    with torch.no_grad():
        for _ in range(n2):
            last = model(cur)[:, -1].float()
            gaps.append(_rel_gap(last))
            nxt = last.argmax(-1)
            want.append(nxt.cpu().numpy())
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    want, gaps = np.stack(want, 1), np.stack(gaps, 1)
    agree = streams_agree(got, want, gaps)
    emit({"generate_capture_check": dict(
        card=card, dtype="float32", batch=b2, prompt=p2, new_tokens=n2,
        min_gap_rel=float(gaps.min()), streams=agree)})
    if not all(r["ok"] for r in agree):
        bad.append(f"captured f32 greedy differs from the full re-forward: "
                   f"{agree}")
    st.release()
    torch.cuda.empty_cache()
    if bad:
        fail("; ".join(bad))
    return rows


TELEMETRY_SPANS = ("admission", "prefill", "decode")
PULSE_COUNTERS = ("tokens_total", "retired_total", "admitted_total")


def telemetry_gates(row):
    """Failures of the telemetry row: streams that moved when the planes
    were armed; serving counters off the engine's own counts (retired
    and the ttft count = the requests; tokens_total = the decode
    boundaries' tokens, the emitted tokens less each request's first,
    which admitted_total counts, as the JAX engine defines them); a
    request without its spans; no tail component; a /metrics answer
    without the counters; an OOM that did not propagate or left no
    counter or receipt, or a receipt whose free bytes are more than 5%
    off mem_get_info's; a TrainStep replay without its step bracket."""
    bad = []
    n, c = row["requests"], row["counters"]
    if not row["streams_equal"]:
        bad.append("telemetry: the streams changed with the planes armed")
    if c["retired_total"] != n or c["ttft_count"] != n:
        bad.append(f"telemetry: retired {c['retired_total']}, ttft count "
                   f"{c['ttft_count']}, expected {n}")
    if c["admitted_total"] != n or \
            c["tokens_total"] != row["tokens_emitted"] - n:
        bad.append(f"telemetry: tokens_total {c['tokens_total']} + "
                   f"admitted_total {c['admitted_total']} != "
                   f"{row['tokens_emitted']} tokens emitted")
    if row["requests_missing_spans"]:
        bad.append(f"telemetry: requests without their spans: "
                   f"{row['requests_missing_spans']}")
    if not row["tail_component"]:
        bad.append("telemetry: explain_tail named no component")
    served = row["pulse_metrics"]
    if set(served) != set(PULSE_COUNTERS) or \
            any(served[k] != c[k] for k in PULSE_COUNTERS):
        bad.append(f"telemetry: /metrics served {row['pulse_metrics']}, the "
                   f"registry holds {c}")
    oom = row["oom"]
    if not (oom["propagated"] and oom["oom_total"] == 1
            and oom["receipt"]):
        bad.append(f"telemetry: the OOM sentry left {oom}")
    elif abs(oom["receipt_free_bytes"] - oom["mem_get_info_free"]) > \
            0.05 * oom["mem_get_info_free"]:
        bad.append(f"telemetry: the receipt's free bytes "
                   f"{oom['receipt_free_bytes']} are more than 5% off "
                   f"mem_get_info's {oom['mem_get_info_free']}")
    tr = row["train_step"]
    if tr["step_begin"] != tr["calls"] or tr["step_end"] != tr["calls"] \
            or tr["steps"] != list(range(tr["calls"])):
        bad.append(f"telemetry: a captured TrainStep left {tr}")
    return bad


def _scrape(port):
    """The serving counters of a /metrics answer from the pulse server on
    127.0.0.1:port."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        for k in PULSE_COUNTERS:
            if line.startswith(f"paddle_tpu_serving_{k} "):
                out[k] = int(float(line.split()[1]))
    return out


def _oom_probe(torch, eng):
    """A real torch.cuda.OutOfMemoryError inside the engine's wrapped
    dispatch (an allocation of the card's whole memory): did it
    propagate, what did the counter and the receipt say."""
    from paddle_tpu_torch.observability import metrics
    out_dir = os.path.join(REPO, "build", "oom_receipts")
    os.environ["PD_OOM_DIR"] = out_dir
    for f in os.listdir(out_dir) if os.path.isdir(out_dir) else ():
        os.remove(os.path.join(out_dir, f))
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    propagated = False
    try:
        eng._dispatch("serving_decode", lambda: torch.empty(
            total, dtype=torch.uint8, device="cuda"), bucket=0)
    except torch.cuda.OutOfMemoryError:
        propagated = True
    torch.cuda.empty_cache()
    receipts = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    doc = {}
    if receipts:
        with open(os.path.join(out_dir, receipts[0])) as f:
            doc = json.load(f)
    return dict(propagated=propagated,
                oom_total=metrics.counter(
                    "memory.oom_total", _always=True,
                    program="serving_decode").value(),
                receipt=receipts[0] if receipts else None,
                receipt_free_bytes=doc.get("free_bytes"),
                receipt_requested_bytes=doc.get("requested_bytes"),
                mem_get_info_free=free, mem_get_info_total=total,
                hint=doc.get("hint"))


def _train_brackets(torch, pt):
    """A captured GPT-2 small TrainStep (8x1024 O1) with the flight
    recorder armed: the first call and 3 replays, each bracketed."""
    from paddle_tpu_torch.observability import flight_recorder as fr
    model = _train_model(pt, "gpt")
    step, x, y, _, _ = _train_step(torch, "gpt", model)
    fr.reset()
    fr.enable(sync_steps=True)
    calls = 4
    for i in range(calls):
        step(x, y, seed=STEP_SEEDS[i])
    fr.disable()
    ev = fr.get_recorder().events()
    row = dict(calls=calls, captures=step.captures, replays=step.replays,
               step_begin=sum(e["k"] == "step.begin" for e in ev),
               step_end=sum(e["k"] == "step.end" for e in ev),
               steps=[e["step"] for e in ev if e["k"] == "step.end"])
    step.release()
    del model, step, x, y
    torch.cuda.empty_cache()
    return row


def telemetry_phase(torch, pt, model):
    """The serving trace of the `serving` phase through a fresh bf16
    engine four times, the planes off, on, off, on (metrics, reqtrace and
    the flight recorder armed together): streams equal, the counters
    and spans against the engine's own counts, tokens/s each way; the
    pulse server's /metrics on 127.0.0.1, port 0; the OOM sentry on a
    real CUDA OOM; the flight recorder's step bracket around a captured
    TrainStep."""
    import numpy as np
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.observability import metrics, pulse_server
    from paddle_tpu_torch.observability import reqtrace as rt
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    vocab = GPT2["vocab_size"]
    eng = ServingEngine(model, ServingConfig(**SERVE_CONFIG)).warmup()
    prompts, news = serve_trace(np, vocab)
    runs = []
    for armed in (False, True, False, True):
        metrics.reset("serving.")
        rt.reset()
        fr.reset()
        if armed:
            metrics.enable()
            rt.enable(capacity=1 << 16)
            fr.enable(sync_steps=False)
        by_rid, secs, steps, _ = _run_trace(eng, prompts, news)
        for plane in (metrics, rt, fr):
            plane.disable()
        tokens = sum(len(r.out) for r in by_rid.values())
        runs.append(dict(armed=armed, seconds=secs, steps=steps,
                         tokens=tokens, tokens_per_s=tokens / secs,
                         streams={i: list(r.out) for i, r in by_rid.items()}))
    snap = metrics.snapshot("serving.")
    counters = {k: snap.get(f"serving.{k}", {}).get("value", 0)
                for k in PULSE_COUNTERS}
    counters["ttft_count"] = snap["serving.ttft_ms"]["count"]
    tls = rt.timelines()
    missing = [rid for rid in range(len(prompts))
               if not set(TELEMETRY_SPANS) <= {
                   s["comp"] for s in tls.get(rid, {}).get("spans", [])}]
    tail = rt.explain_tail()
    srv = pulse_server.PulseServer(port=0).start()
    try:
        scraped = _scrape(srv.port)
    finally:
        srv.stop()
    oom = _oom_probe(torch, eng)
    del eng
    torch.cuda.empty_cache()
    train = _train_brackets(torch, pt)
    off = [r["tokens_per_s"] for r in runs if not r["armed"]]
    on = [r["tokens_per_s"] for r in runs if r["armed"]]
    row = dict(card=nvidia_smi(), requests=len(prompts),
               tokens_emitted=runs[-1]["tokens"],
               streams_equal=all(r["streams"] == runs[0]["streams"]
                                 for r in runs),
               tokens_per_s_off=off, tokens_per_s_on=on,
               armed_cost=1.0 - (sum(on) / len(on)) / (sum(off) / len(off)),
               counters=counters, requests_missing_spans=missing,
               spans=sum(len(t["spans"]) for t in tls.values()),
               tail_component=tail.get("dominant_overall"),
               tail_cohort=len(tail.get("cohort", [])),
               pulse_metrics=scraped, oom=oom, train_step=train)
    emit({"telemetry": row})
    bad = telemetry_gates(row)
    if bad:
        fail("; ".join(bad))
    return row


def gpt_param_count(vocab_size, hidden_size, num_layers, max_seq_len,
                    **_):
    """Parameters of a GPTForCausalLM: token and position embeddings,
    per block two layer norms (4h), qkv (3h^2 + 3h), proj (h^2 + h), fc1
    (4h^2 + 4h) and fc2 (4h^2 + h), and the final layer norm (2h); the
    head is tied to the token embeddings."""
    h = hidden_size
    return ((vocab_size + max_seq_len) * h
            + num_layers * (12 * h * h + 13 * h) + 2 * h)


def chunked_head_work(n, d, vocab, block):
    """The vocab-chunked head of n rows of width d over `vocab` columns
    in blocks of `block` (padded up to a multiple): 4 f32 GEMMs a block
    (the forward's block logits; the backward's rematerialised logits, dh
    and dW), 2 n d flops a column each; their bound on the f32 pipes
    against the bytes they must move (h, W, dh and dW once each), and
    the bytes of one bf16 [n, vocab] logits tensor that the head never
    builds."""
    nb = -(-vocab // block)
    padded = nb * block
    flops = 4 * 2.0 * n * d * padded
    nbytes = (2 * n * d + 2 * d * vocab) * 4
    ms, by = _bound(nbytes, flops, "float32")
    return dict(blocks=nb, padded_vocab=padded, pad=padded - vocab,
                flops=flops, bytes=nbytes, bound_ms=ms, bound_by=by,
                logits_bf16_bytes=n * vocab * 2)


def gpt_train_kernels_phase(torch, fa, philox):
    """The three kernels at GPT-2 small's training shape (b 8, s 1024,
    n 12, h 64, causal, p 0.1, strided qkv views) against their plain
    versions, bf16 and f32, with their times, bounds (the forward's
    Philox floor too) and SDPA's causal forward and backward at the same
    p; then the mask probe at that shape, causal."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    b, s = GPT_TRAIN_BATCH
    n = GPT_TRAIN["num_heads"]
    h = GPT_TRAIN["hidden_size"] // n
    p = GPT_TRAIN["dropout"]
    rows = [bwd_kernel_case(torch, fa, gen, (b, s, n, h, True, dt, p),
                            philox, tag="gpt_train_kernel")
            for dt in ("bfloat16", "float32")]
    probes = [mask_probe_case(torch, fa, b, n, h, s, dt, causal=True)
              for dt in ("bfloat16", "float32")]
    return rows, probes


def gpt_train_path(torch, pt, fa):
    """GPT-2 small pretraining through TrainStep on the card, causal
    dropout through all three kernels."""
    base = torch.cuda.memory_allocated()
    model = _train_model(pt, "gpt")
    row = _train_run(torch, fa, "gpt", model, TRAIN_WARMUP, TRAIN_STEPS,
                     base)
    if row["params"] != gpt_param_count(**GPT_TRAIN):
        fail(f"GPT-2 small has {row['params']} parameters, expected "
             f"{gpt_param_count(**GPT_TRAIN)}")
    row["dropout"] = GPT_TRAIN["dropout"]
    _with_mfu(row, GPT_TRAIN["num_layers"], GPT_TRAIN["hidden_size"])
    row["mfu_note"] = ("bench.py's 6N + 12 L h s a token, the attention "
                       "term not halved for the causal mask")
    prof = row.pop("profile")
    emit({"gpt_train_path": row})
    losses = row["losses"]
    if not losses[-1] < losses[0]:
        fail(f"GPT training loss did not fall on a repeated batch: "
             f"{losses}")
    if not 0 < row["mfu"] < 1:
        fail(f"GPT MFU {row['mfu']} is outside (0, 1)")
    emit({"gpt_profile": prof})
    return row


def linear_ce_check(torch):
    """F.linear_cross_entropy on the card against the port's dense
    F.cross_entropy over f32 logits materialised on purpose (CE_CHECK;
    every 7th label ignored): loss, dh, dW and db within 1e-4 x max(1,
    max|ref|), f32 products with TF32 off. Times of both, forward and
    backward, beside the chunked head's bound."""
    from paddle_tpu_torch.nn import functional as F
    n, d, vocab, block = (CE_CHECK[k] for k in ("n", "d", "vocab", "block"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    h = torch.randn((n, d), generator=gen, device="cuda")
    w = torch.randn((d, vocab), generator=gen, device="cuda") * 0.05
    bias = torch.randn((vocab,), generator=gen, device="cuda") * 0.1
    lbl = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    lbl[::7] = -100

    def run(chunked):
        args = [t.detach().requires_grad_(True) for t in (h, w, bias)]
        if chunked:
            loss = F.linear_cross_entropy(*args, lbl, vocab_block=block)
        else:
            loss = F.cross_entropy(torch.addmm(args[2], args[0], args[1]),
                                   lbl)
        loss.backward()
        return [loss.detach()] + [a.grad for a in args]

    got, ref = run(True), run(False)
    row = dict(n=n, d=d, vocab=vocab, block=block, dtype="float32")
    ok = True
    for name, g, r in zip(("loss", "dh", "dw", "db"), got, ref):
        err, tol, good = _err_ok(g, r, "float32")
        row[f"{name}_max_abs_err"], row[f"{name}_tol"] = err, tol
        ok &= good
    row["ok"] = bool(ok)
    if not ok:
        emit({"chunked_ce_check": row})
        fail(f"linear_cross_entropy disagrees with the dense CE: {row}")
    row["chunked_ms"] = time_ms(lambda: run(True), reps=3, warmup=1)
    row["dense_ms"] = time_ms(lambda: run(False), reps=3, warmup=1)
    row["head"] = chunked_head_work(n, d, vocab, block)
    emit({"chunked_ce_check": row})
    del got, ref
    torch.cuda.empty_cache()
    return row


def chunked_ce_phase(torch, pt, fa, dense):
    """linear_ce_check, then ERNIE-base (48x512) and GPT-2 small (8x1024)
    O1 TrainSteps with chunked_ce=True from the same weights (SEED) and
    batch as their dense steps (dense: {"ernie": train_path's row, "gpt":
    gpt_train_path's}). The step-1 losses (the chunked forward) and the
    step-2 losses (after one update through the chunked backward) agree
    within CE_LOSS_RTOL and
    the chunked peak memory lies below the dense peak (both counted
    above what was allocated before each phase built its model)."""
    check = linear_ce_check(torch)
    rows = {}
    for kind in ("ernie", "gpt"):
        base = torch.cuda.memory_allocated()
        model = _train_model(pt, kind, chunked_ce=True)
        row = _train_run(torch, fa, kind, model, VARIANT_WARMUP,
                         VARIANT_STEPS, base)
        row["profile"]["top"] = row["profile"]["top"][:10]
        # the head's rows: every position (ERNIE's MLM), all but the
        # last of each sequence (GPT's shifted LM loss)
        rows_ce = row["batch"] * (row["seq"] - (kind == "gpt"))
        head = chunked_head_work(rows_ce, model.config.hidden_size,
                                 model.config.vocab_size,
                                 model.config.ce_vocab_block)
        del model
        ref = dense[kind]
        row.update(
            dense_step_ms=ref["step_ms"],
            dense_tokens_per_s=ref["tokens_per_s"],
            dense_peak_above_base_bytes=ref["peak_above_base_bytes"],
            peak_saved_bytes=(ref["peak_above_base_bytes"]
                              - row["peak_above_base_bytes"]),
            logits_bf16_bytes=head["logits_bf16_bytes"], head=head,
            dense_losses=ref["losses"][:2],
            step1_rel_diff=_rel_diff(row["losses"][0], ref["losses"][0]),
            step2_rel_diff=_rel_diff(row["losses"][1], ref["losses"][1]),
            rtol=CE_LOSS_RTOL)
        row["ok"] = (row["step1_rel_diff"] <= CE_LOSS_RTOL
                     and row["step2_rel_diff"] <= CE_LOSS_RTOL
                     and row["peak_saved_bytes"] > 0)
        emit({"chunked_ce": row})
        if not row["ok"]:
            fail(f"the chunked {kind} step disagrees with the dense one "
                 f"or does not save memory: {row}")
        rows[kind] = row
        torch.cuda.empty_cache()
    return check, rows


def _rel_diff(a, b):
    return abs(a - b) / abs(b)


def _scanned_twin(pt, kind):
    """A scan_layers model loaded from its unrolled twin (both from
    SEED) through load_from_layers, the other parameters by name."""
    twin = _train_model(pt, kind)
    model = _train_model(pt, kind, scan_layers=True)
    stack, blocks = ((model.ernie.encoder, twin.ernie.encoder)
                     if kind == "ernie" else
                     (model.gpt.blocks, twin.gpt.blocks))
    stack.load_from_layers(blocks)
    own = model.state_dict()
    model.set_state_dict({k: v for k, v in twin.state_dict().items()
                          if k in own})
    return model


def scan_layers_phase(torch, pt, fa, dense):
    """ERNIE-base and GPT-2 small with scan_layers=True, loaded from
    their unrolled twins: the loss of every step (the first forward,
    then each after the stacked backward and AdamW on the stacks) equals
    the unrolled run's at that step (dense: train_path's and
    gpt_train_path's rows, the same seeds and batch) within SCAN_RTOL,
    every step launches each kernel once per layer (_train_run)."""
    rows = {}
    for kind in ("ernie", "gpt"):
        base = torch.cuda.memory_allocated()
        model = _scanned_twin(pt, kind)
        row = _train_run(torch, fa, kind, model, VARIANT_WARMUP,
                         VARIANT_STEPS, base)
        del model
        ref = dense[kind]["losses"][:len(row["losses"])]
        diffs = [_rel_diff(a, b) for a, b in zip(row["losses"], ref)]
        row.update(unrolled_step_ms=dense[kind]["step_ms"],
                   unrolled_losses=ref, rel_diffs=diffs,
                   max_rel_diff=max(diffs), rtol=SCAN_RTOL)
        row["ok"] = row["max_rel_diff"] <= SCAN_RTOL
        emit({"scan_layers": row})
        if not row["ok"]:
            fail(f"the scanned {kind} step disagrees with the unrolled "
                 f"one: {row}")
        rows[kind] = row
        torch.cuda.empty_cache()
    return rows


def _card(torch):
    return torch.device("cuda", 0)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if hasattr(tree, "cpu") else tree


def _snapshot(step):
    return [p.detach().clone() for p in step.params]


def _bit_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _max_abs_diff(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in
               zip(a, b))


# the step seeds of the graph-vs-eager checks
STEP_SEEDS = [SEED + 100 + i for i in range(4)]
CAPTURE_WARMUP, CAPTURE_STEPS = 2, 12


def active_params(model):
    """Parameters a token runs through: every one, less the experts a
    token is not routed to ((E - k) / E of each MoE layer's w1, b1, w2
    and b2)."""
    total = sum(p.numel() for p in model.parameters())
    cfg = model.config
    skip = 0
    for lyr in getattr(model.ernie, "encoder", []):
        if getattr(lyr, "use_moe", False):
            e = cfg.moe_num_experts
            share = (e - cfg.moe_top_k) / e
            skip += share * sum(t.numel() for t in (
                lyr.moe.w1, lyr.moe.b1, lyr.moe.w2, lyr.moe.b2))
    return int(total - skip)


# the f32 ERNIE-base step (captured_train_f32: no AMP): the device
# kernels a replay runs, by name, each once a layer
F32_TRAIN_ROUTES = {"flash_attn_fwd": "fwd_ffma",
                    "flash_attn_bwd_dq": "dq_ffma",
                    "flash_attn_bwd_dkv": "dkv_ffma"}


def captured_train_phase(torch, pt, fa, kind, key="captured_train",
                         amp_level="O1", routes=None, **step_kw):
    """ERNIE-base 48x512 or GPT-2 small 8x1024, O1 bf16 (amp_level None:
    f32, no AMP), dropout 0.1,
    AdamW: the captured TrainStep against its eager body from one start
    state (the snapshot before step 1, restored in place) and one seed
    sequence (STEP_SEEDS): the first call (warm-up, then capture; the
    peak memory is read over it, as a replay allocates nothing) and 3
    replays against 4 eager steps, losses and every parameter bit-equal;
    one replay repeated from the same state with the same step seed
    gives the same loss, with another seed another loss; then
    CAPTURE_WARMUP + CAPTURE_STEPS replays on a synchronised host clock
    (1 graph, 0 sentinel events), the device time of a replay and the
    kernels each ran (profile_step: each kernel once per layer, as in
    the first call's warm-up), the idle share, tokens/s, MFU, peak
    memory and the eager body's step ms from the same weights; attention's
    share of a replay's device time. routes: the kernel names a replay
    must run once a layer each (captured_train_gates). step_kw goes to
    TrainStep (mesh, sharding_plan); the row is emitted under `key`, its
    MFU from the active parameters (active_params) against the peak of
    the step's compute type. Returns (row, model, step, x, y)."""
    base = torch.cuda.memory_allocated()
    model = _train_model(pt, kind)
    step, x, y, (b, s), layers = _train_step(torch, kind, model, amp_level,
                                             **step_kw)
    s0 = _to_cpu(step.state_dict())    # off the card: not in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_losses = []
    for sd in STEP_SEEDS:
        graph_losses.append(float(step(x, y, seed=sd)))
        if len(graph_losses) == 1:
            # warm-up and capture: what the step needs (a replay
            # allocates nothing; the graph's pool holds it)
            warm = dict(step.last_launches)
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.memory_reserved()
    graph_params = _snapshot(step)
    step.set_state_dict(s0)
    eager_losses = [float(step.eager_step(x, y, seed=sd))
                    for sd in STEP_SEEDS]
    eager_params = _snapshot(step)
    loss_rel = max(_rel_diff(a, e) for a, e in zip(graph_losses,
                                                   eager_losses))
    params_equal = _bit_equal(graph_params, eager_params)
    param_diff = _max_abs_diff(graph_params, eager_params)
    del graph_params, eager_params
    # the step seed decides a replay
    seeded = []
    for sd in (STEP_SEEDS[1], STEP_SEEDS[1], STEP_SEEDS[1] + 7):
        step.set_state_dict(s0)
        seeded.append(float(step(x, y, seed=sd)))
    for _ in range(CAPTURE_WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAPTURE_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    prof = profile_step(torch, step, x, y)
    step_ms = secs / CAPTURE_STEPS * 1e3
    eager_ms = time_ms(lambda: step.eager_step(x, y), reps=5, warmup=1)
    cfg = model.config
    attn_ms = prof["categories"].get("flash attention kernels", 0.0)
    row = dict(model=kind, batch=b, seq=s,
               amp=f"{amp_level} bfloat16" if amp_level else
               "none (float32)", dropout=0.1, params=active_params(model)
               if kind.startswith("ernie") else
               sum(p.numel() for p in step.params),
               params_total=sum(p.numel() for p in step.params),
               graphs=step.programs, captures=step.captures,
               replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               layers=layers, warmup_launches=warm,
               launches_per_replay=prof["launches_per_replay"],
               routes_per_replay={k: v for k, v in
                                  prof["routes_per_replay"].items() if v},
               launches=_sum_launches([warm, prof["kernel_launches"]]),
               counted_calls=COUNTED_CALLS,
               nccl_launches_per_replay=prof["nccl_launches"]
               / PROFILED_REPLAYS, nccl_kernels=prof["nccl_names"],
               step_seeds=STEP_SEEDS, graph_losses=graph_losses,
               eager_losses=eager_losses, max_loss_rel_diff=loss_rel,
               params_bit_equal=params_equal,
               params_max_abs_diff=param_diff,
               same_seed_losses=seeded[:2], other_seed_loss=seeded[2],
               timed_replays=CAPTURE_STEPS, step_ms=step_ms,
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               attention_ms_per_step=attn_ms,
               attention_share=attn_ms / prof["device_ms"],
               attention_kernel_ms={
                   name: sum(r["ms"] for r in prof["top"] if name in r["name"])
                   for keys in KERNEL_EVENTS.values() for name in keys
                   if prof["routes_per_replay"].get(name)},
               tokens_per_s=b * s * CAPTURE_STEPS / secs,
               eager_step_ms=eager_ms, peak_memory_bytes=peak,
               peak_above_base_bytes=peak - base,
               reserved_after_capture_bytes=reserved,
               profile=_profile_row(prof, top=8))
    _with_mfu(row, layers, cfg.hidden_size,
              "bfloat16" if amp_level else "float32")
    bad = captured_train_gates(row, routes)
    row["ok"] = not bad
    emit({key: row})
    if bad:
        fail(f"the captured {kind} step ({key}) disagrees with its eager "
             "body or its contract: " + "; ".join(bad))
    return row, model, step, x, y


def captured_train_gates(row, routes=None):
    """captured_train_phase's failures, each a message (empty: ok): the
    replays bit-equal to the eager steps (losses and every parameter),
    one graph and no sentinel event, the step seed deciding a replay,
    each kernel once a layer in the warm-up and in a replay, finite
    losses, an MFU in (0, 1); with routes, a replay runs exactly the
    kernel names of routes, once a layer each (no other kernel of
    KERNEL_EVENTS)."""
    bad = []
    if not (row["max_loss_rel_diff"] == 0 and row["params_bit_equal"]):
        bad.append("the replays are not bit-equal to the eager steps: "
                   f"losses {row['graph_losses']} against "
                   f"{row['eager_losses']}, parameters max abs diff "
                   f"{row['params_max_abs_diff']}")
    if row["graphs"] != 1 or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events for one signature")
    same = row["same_seed_losses"]
    if not (same[0] == same[1] and row["other_seed_loss"] != same[0]):
        bad.append(f"the step seed does not decide a replay: {same}, "
                   f"another seed {row['other_seed_loss']}")
    want = {k: row["layers"] for k in KERNEL_EVENTS}
    for what in ("warmup_launches", "launches_per_replay"):
        if row[what] != want:
            bad.append(f"{what} {row[what]}, expected {want}")
    if routes is not None:
        want_r = {name: row["layers"] for name in routes.values()}
        if row["routes_per_replay"] != want_r:
            bad.append(f"a replay ran {row['routes_per_replay']}, "
                       f"expected {want_r}")
    if not all(math.isfinite(v) for v in row["graph_losses"]):
        bad.append(f"non-finite losses {row['graph_losses']}")
    if not 0 < row["mfu"] < 1:
        bad.append(f"MFU {row['mfu']} is outside (0, 1)")
    return bad


# the static Program phase (static_train): the Executor's run seeds, the
# wrapper calls a signature's first run counts, and the f32 routes
STATIC_SEEDS = [SEED + 400 + i for i in range(4)]
STATIC_PARITY_STEPS = 2


def _ernie_program(pt, model, b, s, opt):
    """ERNIE-base's forward and pretraining loss recorded into a static
    Program from static.data feeds ("ids", "labels" [b, s] int64), with
    opt.minimize(loss): (program, loss var)."""
    from paddle_tpu_torch import static
    main = static.Program()
    with static.program_guard(main):
        ids = static.data("ids", [b, s], "int64")
        labels = static.data("labels", [b, s], "int64")
        loss = _ernie_loss(model(ids), labels)
        opt.minimize(loss)
    return main, loss


def _adamw(pt, model):
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=1e-4, parameters=model.parameters(),
                 weight_decay=0.01)


def _set_dropout(model, p):
    """Every dropout of an ERNIE model (hidden and attention) at p."""
    for m in model.modules():
        if type(m).__name__ == "Dropout":
            m.p = p
        if hasattr(m, "dropout_p"):
            m.dropout_p = p


def static_train_gates(row):
    bad = []
    if not (row["graph_losses"] == row["eager_losses"]
            and row["params_bit_equal"]):
        bad.append(f"the captured runs are not bit-equal to the "
                   f"Executor's eager replay: {row['graph_losses']} against "
                   f"{row['eager_losses']}, parameters max abs diff "
                   f"{row['params_max_abs_diff']}")
    want = {k: row["layers"] for k in KERNEL_EVENTS}
    for what in ("warmup_launches", "launches_per_eager_step",
                 "launches_per_replay"):
        if row[what] != want:
            bad.append(f"{what} {row[what]}, expected {want}")
    want_r = {name: row["layers"] for name in F32_TRAIN_ROUTES.values()}
    if row["routes_per_replay"] != want_r:
        bad.append(f"a replay ran {row['routes_per_replay']}, expected "
                   f"{want_r}")
    if row["flash_attention_nodes"] != row["layers"] or row["graphs"] != 1:
        bad.append(f"{row['flash_attention_nodes']} flash-attention nodes, "
                   f"{row['graphs']} graphs")
    par = row["trainstep_parity"]
    if not (par["loss_max_rel_diff"] <= TOL["float32"]
            and par["params_max_abs_diff"] <= TOL["float32"]):
        bad.append(f"the dropout-0 Executor steps differ from TrainStep's: "
                   f"{par}")
    if not all(math.isfinite(v) for v in row["graph_losses"]):
        bad.append(f"non-finite losses {row['graph_losses']}")
    return bad


def static_train_phase(torch, pt, fa, f32_row):
    """ERNIE-base (BASE) trained by the static Executor: its forward and
    pretraining loss recorded under program_guard from static.data feeds
    at TRAIN_BATCH, AdamW's minimize, f32 (no AMP stage), dropout 0.1;
    Executor() on the card runs the first call as the warm-up and
    captures the step as one CUDA graph, then replays it. Held: 4 runs
    (STATIC_SEEDS) bit-equal, losses and every parameter, to the
    Executor's own eager replay from the same start state; each of
    fwd_ffma, dq_ffma and dkv_ffma 12 times a step (the warm-up's and an
    eager run's wrapper counts, a replay's kernels by name on the card);
    12 flash-attention nodes in the Program; and, with every dropout at
    0, STATIC_PARITY_STEPS Executor steps against the port's TrainStep f32
    steps from the same weights (losses and parameters within
    TOL["float32"]). Printed: step ms, device ms and peak memory beside
    captured_train_f32's."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import TrainStep
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    model = _train_model(pt, "ernie")
    layers = model.config.num_hidden_layers
    b, s = TRAIN_BATCH
    x, y = _train_batch(torch, model.config.vocab_size, b, s, "cuda")
    feed = {"ids": x, "labels": y}
    opt = _adamw(pt, model)
    for p in model.parameters():
        opt._state_of(p)           # the state exists before the first run
    p0 = [p.detach().clone() for p in model.parameters()]
    o0 = opt.state_dict()
    tr = time.perf_counter()
    main, loss = _ernie_program(pt, model, b, s, opt)
    record_s = time.perf_counter() - tr
    flash_nodes = sum(1 for n in main.ops
                      if (n.op_type or "").endswith(".flash_attention"))
    n_ops = len(main.ops)
    exe = static.Executor()
    _zero(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_losses = []
    for sd in STATIC_SEEDS:
        graph_losses.append(float(exe.run(main, feed, [loss], seed=sd)[0]))
        if len(graph_losses) == 1:
            warm = dict(exe.last_launches)
            peak = torch.cuda.max_memory_allocated()
    graph_params = [p.detach().clone() for p in model.parameters()]

    def restore():
        with torch.no_grad():
            for p, v in zip(model.parameters(), p0):
                p.copy_(v)
        opt.set_state_dict(o0)
    restore()
    eager_losses = [float(exe.eager_run(main, feed, [loss], seed=sd)[0])
                    for sd in STATIC_SEEDS]
    eager_launches = dict(exe.last_launches)
    eager_params = [p.detach().clone() for p in model.parameters()]
    params_equal = _bit_equal(graph_params, eager_params)
    param_diff = _max_abs_diff(graph_params, eager_params)
    del graph_params, eager_params
    prof = profile_calls(torch, lambda: exe.run(main, feed, [loss]),
                         lambda: exe.replays)
    launches = _sum_launches([warm, prof["kernel_launches"]])
    for _ in range(CAPTURE_WARMUP):
        exe.run(main, feed, [loss])
    torch.cuda.synchronize()
    tt = time.perf_counter()
    for _ in range(CAPTURE_STEPS):
        exe.run(main, feed, [loss])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - tt) / CAPTURE_STEPS * 1e3
    eager_ms = time_ms(lambda: exe.eager_run(main, feed, [loss]), reps=2,
                       warmup=1)
    graphs, captures, replays = exe.programs, exe.captures, exe.replays
    exe.close()
    del main, loss
    torch.cuda.empty_cache()
    # dropout 0: the Executor's steps against TrainStep's from p0
    _set_dropout(model, 0.0)
    restore()
    opt_a = _adamw(pt, model)
    main0, loss0 = _ernie_program(pt, model, b, s, opt_a)
    exe0 = static.Executor()
    exec_losses = [float(exe0.run(main0, feed, [loss0])[0])
                   for _ in range(STATIC_PARITY_STEPS)]
    exec_params = [p.detach().clone() for p in model.parameters()]
    exe0.close()
    del main0, loss0
    torch.cuda.empty_cache()
    restore()
    step = TrainStep(model, _ernie_loss, _adamw(pt, model), amp_level=None)
    ts_losses = [float(step(x, y)) for _ in range(STATIC_PARITY_STEPS)]
    ts_params = [p.detach().clone() for p in step.params]
    step.release()
    parity = dict(dropout=0.0, steps=STATIC_PARITY_STEPS,
                  executor_losses=exec_losses, trainstep_losses=ts_losses,
                  loss_max_rel_diff=max(_rel_diff(a, e) for a, e in
                                        zip(exec_losses, ts_losses)),
                  params_max_abs_diff=_max_abs_diff(exec_params, ts_params),
                  tol=TOL["float32"])
    del exec_params, ts_params, step, model, opt, p0
    torch.cuda.empty_cache()
    row = dict(card=nvidia_smi(), model="ERNIE-base", batch=b, seq=s,
               amp="none (float32)", dropout=0.1, layers=layers,
               program_ops=n_ops, flash_attention_nodes=flash_nodes,
               record_s=record_s, graphs=graphs, captures=captures,
               replays=replays, warmup_launches=warm,
               launches_per_eager_step=eager_launches,
               launches_per_replay=prof["launches_per_replay"],
               routes_per_replay={k: v for k, v in
                                  prof["routes_per_replay"].items() if v},
               launches=launches, counted_calls=COUNTED_CALLS,
               step_seeds=STATIC_SEEDS, graph_losses=graph_losses,
               eager_losses=eager_losses, params_bit_equal=params_equal,
               params_max_abs_diff=param_diff, step_ms=step_ms,
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base,
               eager_step_ms=eager_ms,
               captured_train_f32=dict(
                   step_ms=f32_row["step_ms"],
                   device_ms_per_step=f32_row["device_ms_per_step"],
                   peak_memory_bytes=f32_row["peak_memory_bytes"]),
               trainstep_parity=parity, profile=_profile_row(prof, top=8),
               seconds=time.perf_counter() - t0)
    bad = static_train_gates(row)
    row["ok"] = not bad
    emit({"static_train": row})
    if bad:
        fail("static_train: " + "; ".join(bad))
    return row


# the predictor phase: YOLOv3 at YOLO_SERVE's batch and size through
# save_inference_model; ERNIE-base f32 inference through to_static,
# jit.save with a None batch dim, jit.load and a Predictor at two batches
PREDICT_ERNIE = ((32, 128), (16, 128))
PREDICT_TIMED = 10
NMS_KERNEL = "nms_greedy_kernel"


def _yolo_serving_layer(pt, model, c):
    """forward plus predict(nms_type="hard") of `model` as one Layer."""
    import torch

    class ServingYOLO(pt.nn.Layer):
        def __init__(self, det):
            super().__init__()
            self.det = det

        def forward(self, images):
            im = torch.full((images.shape[0], 2), c["size"],
                            dtype=torch.int32, device=images.device)
            return self.det.predict(
                self.det(images), im, conf_thresh=c["conf_thresh"],
                nms_threshold=c["nms_threshold"],
                keep_top_k=c["keep_top_k"], nms_type="hard")
    return ServingYOLO(model).eval()


def predictor_yolo(torch, pt, fa, nms, model, tmp):
    import numpy as np
    from paddle_tpu_torch.jit import InputSpec
    c = YOLO_SERVE
    serving = _yolo_serving_layer(pt, model, c)
    rng = np.random.RandomState(SEED + 7)
    x = torch.from_numpy(rng.randn(c["batch"], 3, c["size"], c["size"])
                         .astype(np.float32) * 0.1).cuda()
    with torch.no_grad():
        ref_d, ref_c = serving(x)
        eager_ms = time_ms(lambda: serving(x), reps=PREDICT_TIMED)
    prefix = os.path.join(tmp, "yolo", "inference")
    t0 = time.perf_counter()
    pt.static.save_inference_model(
        prefix, layer=serving,
        input_spec=[InputSpec([c["batch"], 3, c["size"], c["size"]],
                              "float32")])
    save_s = time.perf_counter() - t0
    pred, feeds, fetches = pt.static.load_inference_model(prefix)
    _zero(fa)
    nms.launches["nms_greedy"] = 0
    dets, counts = pred.run_tensors([x])      # warm-up and capture
    warm = pred.last_launches["nms_greedy"]
    runs = [pred.run_tensors([x]) for _ in range(2)]
    prof = profile_calls(torch, lambda: pred.run_tensors([x]),
                         lambda: pred.replays, kernels=(NMS_KERNEL,))
    ms = time_ms(lambda: pred.run_tensors([x]), reps=PREDICT_TIMED)
    err = max(float((a[0] - ref_d).abs().max()) for a in [(dets,)] + [
        (r[0],) for r in runs])
    count_gap = max(int((r[1].long() - ref_c.long()).abs().max())
                    for r in [(dets, counts)] + runs)
    row = dict(model="YOLOv3", batch=c["batch"], size=c["size"],
               feeds=feeds, fetches=fetches, save_s=save_s,
               graphs=pred.programs, captures=pred.captures,
               nms_launches_warmup=warm, nms_launches_per_replay=prof[
                   "kernels_per_replay"][NMS_KERNEL],
               flash_launches=dict(fa.launches),
               max_abs_err=err, count_max_gap=count_gap,
               detections=counts.tolist(), eager_detections=ref_c.tolist(),
               ms_per_run=ms, eager_ms=eager_ms,
               device_ms_per_run=prof["device_ms"])
    pred.release()
    return row


def predictor_ernie(torch, pt, fa, tmp):
    import numpy as np
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.jit import InputSpec, to_static
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    pt.seed(SEED)
    model = ErnieForPretraining(ErnieConfig.base(**BASE),
                                device="cuda").eval()
    rng = np.random.RandomState(SEED + 11)
    ids = {bs: torch.from_numpy(rng.randint(
        0, BASE["vocab_size"], bs).astype(np.int64)).cuda()
        for bs in PREDICT_ERNIE}
    with torch.no_grad():
        refs = {bs: model(ids[bs]) for bs in PREDICT_ERNIE}
        eager_ms = {f"{b}x{s}": time_ms(lambda: model(ids[(b, s)]),
                                        reps=PREDICT_TIMED)
                    for b, s in PREDICT_ERNIE}
    to_static(model)
    path = os.path.join(tmp, "ernie", "model")
    t0 = time.perf_counter()
    jit.save(model, path, input_spec=[InputSpec([None, PREDICT_ERNIE[0][1]],
                                                "int64")])
    save_s = time.perf_counter() - t0
    if not os.path.exists(path + ".pdmodel"):
        fail("predictor: jit.save wrote no program for ERNIE-base")
    loaded = jit.load(path)
    with torch.no_grad():
        lo = loaded(ids[PREDICT_ERNIE[0]])
    loaded_err = float((lo[0] - refs[PREDICT_ERNIE[0]][0]).abs().max())
    del loaded, lo
    pred = create_predictor(Config(path))
    per_sig = {}
    launches = {k: 0 for k in KERNEL_EVENTS}
    for bs in PREDICT_ERNIE:
        out = pred.run_tensors([ids[bs]])          # warm-up and capture
        warm = {k: pred.last_launches[k] for k in KERNEL_EVENTS}
        again = pred.run_tensors([ids[bs]])
        prof = profile_calls(torch, lambda: pred.run_tensors([ids[bs]]),
                             lambda: pred.replays)
        ref = refs[bs]
        errs = [max(float((o - r).abs().max()) for o, r in zip(got, ref))
                for got in (out, again)]
        scale = max(float(r.abs().max()) for r in ref)
        per_sig[f"{bs[0]}x{bs[1]}"] = dict(
            warmup_launches=warm,
            launches_per_replay=prof["launches_per_replay"],
            routes_per_replay={k: v for k, v in
                               prof["routes_per_replay"].items() if v},
            max_abs_err=max(errs), max_abs_ref=scale,
            ms_per_run=time_ms(lambda: pred.run_tensors([ids[bs]]),
                               reps=PREDICT_TIMED),
            device_ms_per_run=prof["device_ms"])
        for k in launches:
            launches[k] += warm[k] + prof["kernel_launches"][k]
    row = dict(model="ERNIE-base", dtype="float32",
               layers=BASE["num_hidden_layers"], save_s=save_s,
               loaded_max_abs_err=loaded_err, graphs=pred.programs,
               captures=pred.captures, signatures=per_sig,
               launches=launches, eager_ms=eager_ms)
    pred.release()
    del pred, model, refs
    torch.cuda.empty_cache()
    return row


def predictor_gates(row):
    bad = []
    y = row["yolo"]
    if y["nms_launches_warmup"] != 1 or y["nms_launches_per_replay"] != 1:
        bad.append(f"YOLOv3: nms_greedy {y['nms_launches_warmup']} "
                   f"launches in the warm-up, "
                   f"{y['nms_launches_per_replay']} a replay")
    if not y["max_abs_err"] <= 1e-4 or y["count_max_gap"] > 1:
        bad.append(f"YOLOv3: detections {y['max_abs_err']} from eager, "
                   f"counts off by {y['count_max_gap']}")
    if any(y["flash_launches"].values()) or y["graphs"] != 1:
        bad.append(f"YOLOv3: {y['graphs']} graphs, flash launches "
                   f"{y['flash_launches']}")
    e = row["ernie"]
    layers = e["layers"]
    if e["graphs"] != len(PREDICT_ERNIE):
        bad.append(f"ERNIE-base: {e['graphs']} graphs for "
                   f"{len(PREDICT_ERNIE)} signatures")
    for sig, r in e["signatures"].items():
        if r["warmup_launches"]["flash_attn_fwd"] != layers or \
                r["launches_per_replay"]["flash_attn_fwd"] != layers or \
                r["routes_per_replay"] != {
                    F32_TRAIN_ROUTES["flash_attn_fwd"]: layers}:
            bad.append(f"ERNIE-base {sig}: launches {r}")
        if not r["max_abs_err"] <= TOL["float32"] * max(1.0,
                                                        r["max_abs_ref"]):
            bad.append(f"ERNIE-base {sig}: outputs {r['max_abs_err']} from "
                       "the eager forward")
    if not e["loaded_max_abs_err"] <= TOL["float32"] * 10:
        bad.append(f"ERNIE-base: jit.load's forward "
                   f"{e['loaded_max_abs_err']} from eager")
    return bad


def predictor_phase(torch, pt, fa, nms, yolo_model):
    """Two models served through Predictors on the card, each run
    replaying one CUDA graph per input signature
    (paddle_tpu_torch/inference): YOLOv3 (YOLO_SERVE's model and shape)
    as forward plus predict(nms_type="hard") through
    save_inference_model and load_inference_model, held within 1e-4 of
    the eager predict with counts equal but for a box at the score
    threshold (tests/test_yolo.py:183's slack), nms_greedy once a run;
    ERNIE-base f32 through to_static, jit.save with a None batch dim,
    jit.load and a Predictor at PREDICT_ERNIE (two signatures, two
    graphs), fwd_ffma 12 times a run, outputs within TOL["float32"] of
    the eager forward. Printed: ms a run against the eager ms."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pd_predictor_")
    try:
        yolo = predictor_yolo(torch, pt, fa, nms, yolo_model, tmp)
        torch.cuda.empty_cache()
        ernie = predictor_ernie(torch, pt, fa, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = dict(card=nvidia_smi(), yolo=yolo, ernie=ernie,
               seconds=time.perf_counter() - t0)
    bad = predictor_gates(row)
    row["ok"] = not bad
    emit({"predictor": row})
    if bad:
        fail("predictor: " + "; ".join(bad))
    return row


# the sentry on ERNIE-base's captured step (sentry_train): the
# fingerprint period, the replays after the first call (its warm-up and
# capture), their step seeds, the poisoned leaf's name token (an ffn
# weight: scope mlp) and the card-against-CPU check's batch (f32)
SENTRY_K = 4
SENTRY_REPLAYS = 6
SENTRY_SEEDS = [SEED + 300 + i for i in range(1 + SENTRY_REPLAYS)]
SENTRY_POISON = "ffn_in"
SENTRY_CPU_BATCH = (2, 512)
# ERNIE-base's parameters as bench.py counts them (PERF.md section 2)
BENCH_N = 110_111_042


def _host_tree(step, grads):
    """{name: host tensor} of the step's gradients (zeros where a
    parameter took none, as the step's body uses) or parameters."""
    import torch
    out = {}
    for k, p in zip(step._param_names, step.params):
        t = p if not grads else (p.grad if p.grad is not None
                                 else torch.zeros_like(p))
        out[k] = t.detach().cpu()
    return out


def _stats_agree(got, want, l2_rtol):
    """(ok, worst l2 relative gap): per-scope rows of a sentry output
    against host_stats_by_scope's: the same scopes, counts and max-abs
    exact, l2 within l2_rtol relative."""
    if set(got) != set(want):
        return False, None
    worst = 0.0
    ok = True
    for sc in want:
        ok &= got[sc]["nonfinite"] == want[sc]["nonfinite"]
        ok &= got[sc]["max_abs"] == want[sc]["max_abs"]
        gap = abs(got[sc]["l2"] - want[sc]["l2"]) / max(want[sc]["l2"],
                                                        1e-30)
        worst = max(worst, gap)
    return bool(ok and worst <= l2_rtol), worst


def _kept_sentry(S, **cfg):
    """A NumericSentry that keeps each consumed step's host values while
    .keep is set (an extra device-to-host copy a step)."""
    class Kept(S.NumericSentry):
        def __init__(self, config):
            super().__init__(config)
            self.kept, self.keep = [], True

        def consume(self, step, out):
            if self.keep:
                self.kept.append(S.unpack(out))
            return super().consume(step, out)
    return Kept(S.SentryConfig(**cfg))


def _timed_calls(torch, step, x, y, n):
    """(step ms, seconds) of n calls on a synchronised host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return secs / n * 1e3, secs


def sentry_train_phase(torch, pt, fa):
    """ERNIE-base pretraining under the numeric sentry: captured_train's
    step (48x512, O1 bf16, dropout 0.1, AdamW) with
    TrainStep(sentry=NumericSentry(SentryConfig(fingerprint_every=
    SENTRY_K))), the first call (warm-up and capture) and SENTRY_REPLAYS
    replays, against the same calls of the same step without the sentry
    (anatomy_phase's step, run first): the parameters after them bit for
    bit; each step's per-scope statistics against host_stats_by_scope of
    that step's gradients and parameters copied to the host (counts and
    max-abs exact, l2 at 1e-4 relative); each fresh fingerprint against
    host_fingerprint of the parameters, bit for bit; 1 graph, 0 sentinel
    events, and the kernels a replay ran (each flash kernel once a
    layer). Cost: step ms and device ms of timed replays with the sentry
    against the plain step's, the sentry's share of the step and its
    kernels a replay. Then one step with a NaN written into an ffn_in
    weight's gradient (chaos nan_grad through the TrainStep's grad_hook)
    must be flagged at that step, name its scope (mlp) and stamp the
    health unhealthy. Last, one f32 step of ERNIE-base at
    SENTRY_CPU_BATCH, dropout 0, from the same weights on the card and
    on the CPU: the sentry's per-scope statistics agree at 1e-3
    relative."""
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.observability import sentry as S
    plain = anatomy_phase(torch, pt, fa)
    sen = _kept_sentry(S, fingerprint_every=SENTRY_K)
    model = _train_model(pt, "ernie")
    step, x, y, (b, s), layers = _train_step(torch, "ernie", model,
                                             sentry=sen)
    stats_ok, worst, fps = True, 0.0, []
    for i, sd in enumerate(SENTRY_SEEDS):
        step(x, y, seed=sd)
        host = sen.kept[-1]
        for fam, grads in (("grad", True), ("param", False)):
            want = S.host_stats_by_scope(_host_tree(step, grads))
            ok, gap = _stats_agree(host[fam], want, 1e-4)
            stats_ok &= ok
            worst = max(worst, gap or 0.0)
        if host["fp_fresh"]:
            fps.append(dict(step=i, fingerprint=host["fp"],
                            host=S.host_fingerprint(_host_tree(step,
                                                               False))))
        if i == 0:
            warm = dict(step.last_launches)
    params_equal = _bit_equal(_snapshot(step),
                              [t.to("cuda") for t in plain["params"]])
    sen.keep = False
    ms, _ = _timed_calls(torch, step, x, y, SENTRY_REPLAYS)
    prof = profile_step(torch, step, x, y)
    _expect_launches("ernie sentry", [warm, prof["launches_per_replay"]],
                     layers)
    # the poisoned step: a NaN in one ffn_in weight's gradient
    before = sen.monitor.health_stamp()
    at = step._steps_done
    plan = chaos.ChaosPlan("nan_grad", step=at, rank=0, every=False,
                           stall_s=0.0, scope=SENTRY_POISON)
    step.grad_hook = lambda g: chaos.apply_numeric(g, "nan_grad", plan)
    step(x, y)
    step.grad_hook = None
    flagged = [a for a in sen.monitor.anomalies if a["step"] == at]
    stamp = sen.monitor.health_stamp()
    poison = dict(step=at, anomalies=[{k: v for k, v in a.items()
                                       if k != "ts"} for a in flagged],
                  health_before=before, health=stamp)
    poison_ok = (any(a["kind"] == "nonfinite" and a["scope"] == "mlp"
                     and a["stream"] == "grad.nonfinite" for a in flagged)
                 and before["healthy"] and not stamp["healthy"])
    row = dict(model="ernie", batch=b, seq=s, amp="O1 bfloat16",
               dropout=0.1, fingerprint_every=SENTRY_K,
               replays_checked=SENTRY_REPLAYS, graphs=step.programs,
               sentinel_events=step.recompile_sentinel.fired,
               params_bit_equal_to_plain=params_equal,
               stats_equal_host=stats_ok, stats_l2_worst_rel_gap=worst,
               stats_l2_tol=1e-4, fingerprints=fps,
               fingerprints_equal_host=all(f["fingerprint"] == f["host"]
                                           for f in fps),
               step_ms=ms, plain_step_ms=plain["step_ms"],
               device_ms_per_step=prof["device_ms"],
               plain_device_ms_per_step=plain["device_ms"],
               sentry_device_share=(prof["device_ms"] - plain["device_ms"])
               / prof["device_ms"],
               sentry_kernels_per_replay=(prof["events"]
                                          - plain["events"]),
               kernels_per_replay=prof["events"],
               plain_kernels_per_replay=plain["events"],
               launches_per_replay=prof["launches_per_replay"],
               poisoned=poison, poisoned_ok=poison_ok)
    step.release()
    del model, step
    torch.cuda.empty_cache()
    row["card_vs_cpu"] = _sentry_card_vs_cpu(torch, pt, S)
    row["ok"] = bool(
        row["graphs"] == 1 and row["sentinel_events"] == 0
        and params_equal and stats_ok and fps
        and row["fingerprints_equal_host"] and poison_ok
        and row["card_vs_cpu"]["ok"])
    emit({"sentry_train": row})
    if not row["ok"]:
        fail(f"sentry_train: {row}")
    return row, plain


def _sentry_card_vs_cpu(torch, pt, S):
    """One f32 TrainStep step of ERNIE-base at SENTRY_CPU_BATCH, dropout
    0, with the sentry, from the same weights on the card and on the
    CPU: the per-scope statistics of both within 1e-3 relative (counts
    exact)."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg = ErnieConfig.base(**BASE, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    pt.seed(SEED + 3)
    gm = ErnieForPretraining(cfg, device="cuda").train()
    cm = ErnieForPretraining(cfg, device="cpu").train()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    b, s = SENTRY_CPU_BATCH
    got = {}
    t0 = time.perf_counter()
    for name, m, dev in (("card", gm, "cuda"), ("cpu", cm, "cpu")):
        sen = _kept_sentry(S, fingerprint_every=1)
        st = TrainStep(m, _ernie_loss, AdamW(learning_rate=1e-4,
                                             weight_decay=0.01),
                       sentry=sen)
        xx, yy = _train_batch(torch, cfg.vocab_size, b, s, dev)
        st.eager_step(xx, yy, seed=SEED)
        st.sentry.consume(0, st._sentry_out)
        got[name] = sen.kept[-1]
        del st
    worst, ok = 0.0, True
    for fam in ("grad", "param"):
        a, c = got["card"][fam], got["cpu"][fam]
        ok &= set(a) == set(c)
        for sc in c:
            ok &= a[sc]["nonfinite"] == c[sc]["nonfinite"]
            for stat in ("max_abs", "l2"):
                gap = abs(a[sc][stat] - c[sc][stat]) / max(
                    abs(c[sc][stat]), 1e-30)
                worst = max(worst, gap)
    del gm, cm
    torch.cuda.empty_cache()
    return dict(batch=[b, s], dtype="float32", dropout=0.0,
                max_rel_gap=worst, tol=1e-3, seconds=time.perf_counter()
                - t0, ok=bool(ok and worst <= 1e-3))


def anatomy_phase(torch, pt, fa):
    """The port's tracing of captured_train's ERNIE-base step (no
    sentry; sentry_train holds its sentry step against this one): the
    first call and SENTRY_REPLAYS replays with SENTRY_SEEDS (the
    parameters after them kept for sentry_train), timed replays and a
    profiled pair (step ms, device ms, device events); then
    train_step_memory (the step from shapes alone: predicted peak and
    top scopes) beside the temp peak of a real eager step
    (torch.cuda.max_memory_allocated over it, the graph released
    first); train_step_anatomy of an eager step under torch.profiler:
    FLOPs by scope, their sum against mfu.step_flops of another eager
    step and against bench.py's tokens x (6N + 12 L h s), device ms by
    scope (xprof.attribute_device_time) against the profiler's own
    device total of that trace (within 1%); ThroughputMeter's tokens/s
    and MFU over the timed replays against chip_peak_flops() of the
    card; and the calibration probes on the card (build_table,
    synthetic=False), whose Calibration predicts the step
    (MeshPlan(dp=1).predict) and audit reports the relative errors
    against the measured step time and peak."""
    from paddle_tpu_torch.distributed.sharding import MeshPlan, ModelDims
    from paddle_tpu_torch.observability import (anatomy, calibration,
                                                memory, mfu)
    model = _train_model(pt, "ernie")
    step, x, y, (b, s), layers = _train_step(torch, "ernie", model)
    for sd in SENTRY_SEEDS:
        step(x, y, seed=sd)
    params = [p.detach().cpu() for p in step.params]
    ms, secs = _timed_calls(torch, step, x, y, SENTRY_REPLAYS)
    prof = profile_step(torch, step, x, y)
    tokens = b * s
    meter = mfu.ThroughputMeter(tokens, peak_flops=mfu.chip_peak_flops(),
                                n_devices=1)
    step.release()
    torch.cuda.empty_cache()
    # memory: predicted from shapes alone, and a real eager step's peak
    mem = memory.train_step_memory(step, x, y, program="train_step")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step.eager_step(x, y, seed=SEED)
    torch.cuda.synchronize()
    real_temp = torch.cuda.max_memory_allocated() - before
    args = mem["arguments"]["total_bytes"]
    # FLOPs and device ms by scope, then the whole step's FLOPs
    anat = anatomy.train_step_anatomy(step, x, y, seed=SEED, profile=True)
    flops = mfu.step_flops(step.eager_step, x, y, seed=SEED)
    meter.flops_per_step = flops
    for _ in range(SENTRY_REPLAYS):
        meter.step(secs / SENTRY_REPLAYS)
    thr = meter.report()
    bench_flops = tokens * train_flops_per_token(
        BENCH_N, layers, model.config.hidden_size, s)
    dev = anat["device_ms"]
    dev_sum = sum(dev["per_scope_ms"].values())
    # calibration on the card, the step predicted and audited
    t0 = time.perf_counter()
    table = calibration.build_table(synthetic=False)
    calib = calibration.Calibration(table)
    dims = ModelDims(n_params=BENCH_N, hidden=model.config.hidden_size,
                     n_layers=layers, seq=s, batch=b)
    receipt = MeshPlan(dp=1).predict(dims, calibration=calib)
    aud = calibration.audit(receipt, {"step_time_s": ms / 1e3,
                                      "hbm_bytes": args + real_temp,
                                      "wire_bytes": 0.0})
    probe_s = time.perf_counter() - t0
    row = dict(
        model="ernie", batch=b, seq=s, amp="O1 bfloat16", dropout=0.1,
        source=anat["source"], step_ms=ms, device_ms=prof["device_ms"],
        events=prof["events"],
        flops_by_scope={k: v["flops"] for k, v in anat["scopes"].items()},
        flops_share={k: v["share"] for k, v in anat["scopes"].items()},
        flops_total=anat["total_flops"], step_flops=flops,
        bench_formula_flops=bench_flops,
        flops_over_bench_formula=flops / bench_flops,
        device_ms_by_scope=dev["per_scope_ms"],
        device_ms_by_scope_sum=dev_sum,
        profiler_device_ms=dev["profiler_device_ms"],
        device_sum_rel_gap=abs(dev_sum - dev["profiler_device_ms"])
        / dev["profiler_device_ms"],
        eager_device_busy_ms=dev["device_busy_ms"],
        eager_idle_ms=dev["idle_ms"],
        throughput=dict(thr, tokens_per_s=thr["examples_per_sec"],
                        peak_flops=meter.peak_flops_total,
                        card=torch.cuda.get_device_name(0)),
        memory=dict(predicted_peak_bytes=mem["peak_bytes"],
                    predicted_argument_bytes=args,
                    predicted_temp_bytes=mem["total_bytes"],
                    top_scopes=[dict(scope=k, bytes=v["bytes"],
                                     share=v["share"])
                                for k, v in list(mem["scopes"].items())[:5]],
                    real_temp_bytes=real_temp,
                    real_peak_bytes=args + real_temp,
                    predicted_over_real=mem["peak_bytes"]
                    / (args + real_temp),
                    temp_predicted_over_real=mem["total_bytes"]
                    / real_temp),
        calibration=dict(device_kind=table["device_kind"],
                         hbm_copy_bytes_per_s=table[
                             "hbm_copy_bytes_per_s"],
                         matmul_flops_per_s=table["matmul_flops_per_s"],
                         predicted_step_s=receipt.predicted_step_time_s,
                         predicted_hbm_bytes=receipt.predicted_hbm_bytes,
                         audit=aud, seconds=probe_s))
    row["ok"] = bool(
        anat["total_flops"] == flops and flops > 0
        and row["device_sum_rel_gap"] <= 0.01
        and {"attn", "mlp", "mlm_head_ce"} <= set(anat["scopes"])
        and {"attn", "mlp", "embed", "mlm_head_ce",
             "optimizer"} <= set(dev["per_scope_ms"])
        and mem["peak_bytes"] > 0 and 0 < thr["mfu"] < 1
        and aud["metrics_joined"] == 3)
    emit({"anatomy": row})
    if not row["ok"]:
        fail(f"anatomy: {row}")
    out = dict(row, params=params)
    del model, step
    torch.cuda.empty_cache()
    return out


# the optimizer extras over ERNIE-base's captured step: steps, EMA
# decay, ModelAverage's window, Lookahead's k and alpha
EXTRAS_STEPS = 4
EXTRAS_DECAY = 0.9
EXTRAS_K, EXTRAS_ALPHA = 2, 0.5


def optimizer_extras_phase(torch, pt):
    """EMA, ModelAverage and Lookahead over ERNIE-base's parameters after
    captured steps (captured_train's step, EXTRAS_STEPS calls: the first
    captures, the rest replay), each updated after every step; then
    apply() and restore() hold values equal to a CPU recomputation of
    the same updates in float64 from the per-step parameters copied to
    the host (EMA: d s + (1 - d) p; ModelAverage's window with its
    restarts; Lookahead's slow weights, written into the parameters at
    every k-th step), at 1e-6 relative to each tensor's largest value,
    and restore() gives back the live parameters bit for bit, at the
    same addresses."""
    from paddle_tpu_torch.optimizer import (ExponentialMovingAverage,
                                            LookaheadOptimizer,
                                            ModelAverage)
    model = _train_model(pt, "ernie")
    step, x, y, _, _ = _train_step(torch, "ernie", model)
    params = step.params
    ema = ExponentialMovingAverage(params, decay=EXTRAS_DECAY)
    avg = ModelAverage(parameters=params, min_average_window=2,
                       max_average_window=3)
    look = LookaheadOptimizer(step.optimizer, alpha=EXTRAS_ALPHA,
                              k=EXTRAS_K)
    look.start()

    def gap(live, want):
        return max(float((t.detach().cpu().double() - w).abs().max()
                         / max(float(w.abs().max()), 1e-30))
                   for t, w in zip(live, want))
    # the CPU recomputation from the parameters each update saw (the
    # Lookahead sync rewrites them after)
    shadow = [p.detach().cpu().double() for p in params]
    slow = [t.clone() for t in shadow]
    total = [torch.zeros_like(t) for t in shadow]
    window, look_gap = 0, 0.0
    for i in range(EXTRAS_STEPS):
        step(x, y, seed=SEED + 400 + i)
        fast = [p.detach().cpu().double() for p in params]
        ema.update()
        avg.step()
        look.sync()
        shadow = [EXTRAS_DECAY * sh + (1 - EXTRAS_DECAY) * f
                  for sh, f in zip(shadow, fast)]
        window += 1
        total = [t + f for t, f in zip(total, fast)]
        limit = max(avg.min_window, min(avg.max_window,
                                        int(avg.rate * (i + 1)) or 1))
        if window > limit:
            total, window = [t / window for t in total], 1
        if (i + 1) % EXTRAS_K == 0:
            slow = [sl + EXTRAS_ALPHA * (f - sl)
                    for sl, f in zip(slow, fast)]
            look_gap = max(look_gap, gap(params, slow))
    mean = [t / window for t in total]
    live = [p.detach().clone() for p in params]
    ptrs = [p.data_ptr() for p in params]
    with ema.apply():
        ema_gap = gap(params, shadow)
    restored = _bit_equal(live, [p.detach() for p in params])
    with avg.apply():
        avg_gap = gap(params, mean)
    restored &= _bit_equal(live, [p.detach() for p in params])
    same_ptrs = [p.data_ptr() for p in params] == ptrs
    row = dict(model="ernie", steps=EXTRAS_STEPS, captured=True,
               graphs=step.programs, ema_decay=EXTRAS_DECAY,
               ema_max_rel_gap=ema_gap, window=window,
               average_max_rel_gap=avg_gap, lookahead_k=EXTRAS_K,
               lookahead_alpha=EXTRAS_ALPHA,
               lookahead_syncs=EXTRAS_STEPS // EXTRAS_K,
               lookahead_max_rel_gap=look_gap, tol=1e-6,
               restore_bit_equal=restored, addresses_kept=same_ptrs)
    row["ok"] = bool(ema_gap <= 1e-6 and avg_gap <= 1e-6
                     and look_gap <= 1e-6 and restored and same_ptrs
                     and step.programs == 1)
    emit({"optimizer_extras": row})
    step.release()
    del model, step
    torch.cuda.empty_cache()
    if not row["ok"]:
        fail(f"optimizer_extras: {row}")
    return row


# the overflow: an infinite scale makes every gradient of that step
# non-finite (a finite one, even 2^127, may not: the loss's own gradient
# is small)
SCALER_INIT, SCALER_OVERFLOW = 2.0 ** 15, math.inf
SCALER_ACCUM = 2
AMP_KEYS = ("amp_scale", "amp_good", "amp_bad", "amp_skipped")


def _finite(states):
    """The scale states with a non-finite number as its string (the
    lines stay strict JSON)."""
    return [{k: v if math.isfinite(v) else str(v) for k, v in st.items()}
            for st in states]


def captured_scaler_phase(torch, pt, fa):
    """GPT-2 small 8x1024, O1 bf16, dropout 0.1, AdamW, with a GradScaler
    (SCALER_INIT, dynamic) and grad_accum_steps=SCALER_ACCUM (the
    microbatch loop unrolled in the graph): from one start state and
    STEP_SEEDS, the first call and 3 replays against 4 eager steps.
    Before the third step the scale is set to SCALER_OVERFLOW in place,
    and back to SCALER_INIT before the fourth, so the third step's
    gradients are non-finite and the skip select runs inside the graph.
    Losses, the loss-scale state after every step and the final
    parameters bit-equal; the overflowing step leaves the parameters as
    they were and counts one skip; every call launches each kernel once
    per layer and microbatch (the first call's warm-up by the wrappers,
    two replays on the card). Returns the row."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    model = _train_model(pt, "gpt")
    layers = model.config.num_layers
    step = TrainStep(model, _gpt_lm_loss,
                     AdamW(learning_rate=1e-4, weight_decay=0.01),
                     amp_level="O1", amp_dtype="bfloat16",
                     grad_accum_steps=SCALER_ACCUM,
                     scaler=GradScaler(init_loss_scaling=SCALER_INIT))
    x, y = _train_batch(torch, model.config.vocab_size, *GPT_TRAIN_BATCH,
                        "cuda")
    s0 = _to_cpu(step.state_dict())
    runs = {}
    for mode in ("graph", "eager"):
        step.set_state_dict(s0)
        call = step if mode == "graph" else step.eager_step
        losses, amp = [], []
        for i, sd in enumerate(STEP_SEEDS):
            scale = step.strategy_state["amp_scale"]
            if i == 2:
                scale.fill_(SCALER_OVERFLOW)
                before = _snapshot(step)
            elif i == 3:
                scale.fill_(SCALER_INIT)
            losses.append(float(call(x, y, seed=sd)))
            if i == 0 and mode == "graph":
                warm = dict(step.last_launches)
            if i == 2:
                skip_kept = _bit_equal(before, _snapshot(step))
                del before
            amp.append({k: float(step.strategy_state[k]) for k in AMP_KEYS})
        runs[mode] = dict(losses=losses, amp=amp, skip_kept_params=skip_kept,
                          params=_snapshot(step))
        if mode == "graph":
            prof = profile_step(torch, step, x, y)
    g, e = runs["graph"], runs["eager"]
    _expect_launches("gpt scaler accum", [warm, prof["launches_per_replay"]],
                     layers * SCALER_ACCUM)
    row = dict(model="gpt", batch=GPT_TRAIN_BATCH[0], seq=GPT_TRAIN_BATCH[1],
               amp="O1 bfloat16", dropout=0.1,
               grad_accum_steps=SCALER_ACCUM, init_scale=SCALER_INIT,
               overflow_scale_at_step_3=str(SCALER_OVERFLOW),
               graphs=step.programs, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               step_seeds=STEP_SEEDS, graph_losses=g["losses"],
               eager_losses=e["losses"], graph_amp_state=_finite(g["amp"]),
               eager_amp_state=_finite(e["amp"]),
               params_bit_equal=_bit_equal(g["params"], e["params"]),
               params_max_abs_diff=_max_abs_diff(g["params"], e["params"]),
               overflow_kept_params=[g["skip_kept_params"],
                                     e["skip_kept_params"]],
               launches_per_replay=prof["launches_per_replay"],
               launches=_sum_launches([warm, prof["kernel_launches"]]),
               counted_calls=COUNTED_CALLS)
    row["ok"] = bool(
        row["graphs"] == 1 and row["sentinel_events"] == 0
        and g["losses"] == e["losses"] and g["amp"] == e["amp"]
        and row["params_bit_equal"] and all(row["overflow_kept_params"])
        and g["amp"][1]["amp_skipped"] == 0
        and g["amp"][2]["amp_skipped"] == 1
        and g["amp"][3]["amp_skipped"] == 1
        and all(math.isfinite(v) for v in g["losses"]))
    emit({"captured_train_scaler": row})
    step.release()
    del step, model, runs, g, e, s0
    torch.cuda.empty_cache()
    if not row["ok"]:
        fail(f"the captured step with a GradScaler and grad_accum_steps "
             f"disagrees with its eager body: {row}")
    return row


def captured_eval_phase(torch, step, x):
    """build_eval_fn (one graph per signature) against the eager eval
    forward of the same model, bit-equal, f32 weights (GPT-2 small)."""
    ev = step.build_eval_fn()
    got = ev(x)
    again = ev(x)
    model = step.layer
    model.eval()
    with torch.no_grad():
        ref = model(x)
    model.train()
    got, again, ref = ((t,) if isinstance(t, torch.Tensor) else tuple(t)
                       for t in (got, again, ref))
    row = dict(batch=tuple(x.shape), graphs=ev.programs,
               replays=ev.replays, bit_equal=_bit_equal(got, ref)
               and _bit_equal(again, ref),
               max_abs_diff=_max_abs_diff(got, ref),
               ms=time_ms(lambda: ev(x), reps=5, warmup=1))
    row["ok"] = bool(row["bit_equal"] and row["graphs"] == 1)
    emit({"captured_eval": row})
    if not row["ok"]:
        fail(f"the captured eval forward disagrees with the eager one: "
             f"{row}")
    del ev, got, again, ref
    torch.cuda.empty_cache()


def lr_schedule_phase(torch, pt):
    """A captured GPT-2 small step under LinearWarmup (4 warm-up steps to
    1e-4): the lr each replay reads (its buffer word) equals the
    scheduler's get_lr() at that step in f32, and the parameters after 5
    steps are bit-equal to the eager body's under the same schedule."""
    import numpy as np
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import LinearWarmup
    from paddle_tpu_torch.static import TrainStep
    model = _train_model(pt, "gpt")
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    x, y = _train_batch(torch, model.config.vocab_size, *GPT_TRAIN_BATCH,
                        "cuda")
    runs = {}
    for mode in ("graph", "eager"):
        model.set_state_dict(w0)
        sched = LinearWarmup(learning_rate=1e-4, warmup_steps=4,
                             start_lr=0.0, end_lr=1e-4)
        step = TrainStep(model, _gpt_lm_loss,
                         AdamW(learning_rate=sched, weight_decay=0.01),
                         amp_level="O1", amp_dtype="bfloat16")
        want, read = [], []
        for sd in STEP_SEEDS + [STEP_SEEDS[-1] + 1]:
            want.append(float(np.float32(sched.get_lr())))
            if mode == "graph":
                step(x, y, seed=sd)
                if step.last_lr is not None:
                    read.append(float(step.last_lr))
            else:
                step.eager_step(x, y, seed=sd)
            sched.step()
        runs[mode] = dict(params=_snapshot(step), want=want, read=read,
                          replays=step.replays)
        step.release()
        del step
    g, e = runs["graph"], runs["eager"]
    row = dict(steps=len(g["want"]), replays=g["replays"],
               scheduler_lr=g["want"], replay_lr=g["read"],
               lr_equal=g["read"] == g["want"][1:],
               params_bit_equal=_bit_equal(g["params"], e["params"]),
               params_max_abs_diff=_max_abs_diff(g["params"], e["params"]))
    row["ok"] = bool(row["lr_equal"] and row["params_bit_equal"]
                     and g["replays"] == len(g["want"]) - 1)
    emit({"lr_schedule": row})
    if not row["ok"]:
        fail(f"the captured step does not follow the scheduler: {row}")
    del model, runs
    torch.cuda.empty_cache()


# the ten optimizers of paddle_tpu/optimizer/optimizers.py, one setting
# each, and GPT-2-width tensors: qkv weight and bias, an MLP weight, the
# embedding
OPTIMIZERS = [
    ("SGD", dict(learning_rate=1e-2)),
    ("Momentum", dict(learning_rate=1e-2, use_nesterov=True)),
    ("Adam", dict(learning_rate=1e-3)),
    ("AdamW", dict(learning_rate=1e-3, weight_decay=0.01)),
    ("Adagrad", dict(learning_rate=1e-2)),
    ("Adadelta", dict(learning_rate=1.0)),
    ("Adamax", dict(learning_rate=1e-3)),
    ("RMSProp", dict(learning_rate=1e-3, momentum=0.9, centered=True)),
    ("Lamb", dict(learning_rate=1e-3)),
    ("Lars", dict(learning_rate=1e-2)),
]
OPT_SHAPES = [(768, 2304), (2304,), (768, 3072), (50304, 768)]
OPT_STEPS = 4


def optimizers_phase(torch):
    """Each optimizer's apply_gradients captured as a CUDA graph (after a
    warm-up step on a side stream) against the same updates run eagerly,
    from the same params and OPT_STEPS gradients: params and every state
    tensor bit-equal, in f32 and in bf16 with multi_precision (f32
    masters)."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.static.capture import capture, warm_up
    dev = _card(torch)
    rows = []
    for name, kw in OPTIMIZERS:
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(SEED + 17)
            init = [torch.randn(sh, generator=gen, device=dev).to(dt)
                    for sh in OPT_SHAPES]
            grads = [[torch.randn(sh, generator=gen, device=dev).to(dt)
                      * 1e-2 for sh in OPT_SHAPES]
                     for _ in range(OPT_STEPS)]
            lr = torch.tensor(kw["learning_rate"], dtype=torch.float32,
                              device=dev)
            sides = []
            for _ in range(2):
                ps = [t.clone() for t in init]
                opt = getattr(topt, name)(**kw, parameters=ps)
                opt._multi_precision = dt == torch.bfloat16
                sides.append((ps, opt))
            (pa, oa), (pb, ob) = sides
            static = [g.clone() for g in grads[0]]
            warm_up(lambda: oa.apply_gradients(pa, static, lr=lr), dev)
            graph, _ = capture(lambda: oa.apply_gradients(pa, static, lr=lr),
                               dev)
            for gs in grads[1:]:
                for s_, g in zip(static, gs):
                    s_.copy_(g)
                graph.replay()
            for gs in grads:
                ob.apply_gradients(pb, gs, lr=lr)
            torch.cuda.synchronize()
            sa = [t for p in pa for t in oa._accumulators[id(p)].values()]
            sb = [t for p in pb for t in ob._accumulators[id(p)].values()]
            row = dict(optimizer=name, dtype=str(dt).split(".")[-1],
                       multi_precision=dt == torch.bfloat16,
                       steps=OPT_STEPS, state=sorted(
                           oa._accumulators[id(pa[0])]),
                       bit_equal=_bit_equal(pa, pb) and _bit_equal(sa, sb)
                       and len(sa) == len(sb),
                       moved=not _bit_equal(pa, init))
            rows.append(row)
            del graph, sides, pa, pb, oa, ob, static, grads, init
    torch.cuda.empty_cache()
    ok = all(r["bit_equal"] and r["moved"] for r in rows)
    emit({"optimizers": dict(shapes=OPT_SHAPES, rows=rows, ok=ok)})
    if not ok:
        fail(f"a captured optimizer update differs from the eager one: "
             f"{[r for r in rows if not (r['bit_equal'] and r['moved'])]}")


REMAT_POLICIES = [None, "nothing_saveable", "checkpoint_dots"]
REMAT_TIMED = 5


def remat_phase(torch, pt, fa, kind):
    """The plain captured step, then remat with each of REMAT_POLICIES,
    each from the same weights (SEED) and fresh AdamW state, at
    STEP_SEEDS[:2]: step-1 and step-2 losses bit-equal to the plain
    step's; the remat step
    launches the forward twice per layer (its recompute) and each
    backward kernel once; step ms over REMAT_TIMED replays and the peak
    memory above the weights (over the warm-up and the capture: a
    replay allocates nothing) and the device ms of a replay beside the
    plain step's. Launches: the first call's warm-up by the wrappers,
    two replays on the card (profile_step). Returns the rows (their
    counted launches summed)."""
    model = _train_model(pt, kind)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rows = {}
    for policy in ["plain"] + REMAT_POLICIES:
        model.set_state_dict(w0)
        kw = {} if policy == "plain" else dict(remat=True,
                                               remat_policy=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step, x, y, (b, s), layers = _train_step(torch, kind, model, **kw)
        losses = [float(step(x, y, seed=STEP_SEEDS[0]))]
        warm = dict(step.last_launches)
        losses.append(float(step(x, y, seed=STEP_SEEDS[1])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REMAT_TIMED):
            step(x, y)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prof = profile_step(torch, step, x, y)
        _expect_launches(f"{kind} remat {policy}",
                         [warm, prof["launches_per_replay"]], layers,
                         fwd=1 if policy == "plain" else 2)
        rows[str(policy)] = dict(
            policy=policy, losses=losses, step_ms=secs / REMAT_TIMED * 1e3,
            device_ms_per_step=prof["device_ms"],
            peak_above_base_bytes=peak - base,
            launches_per_step=prof["launches_per_replay"],
            launches=_sum_launches([warm, prof["kernel_launches"]]),
            counted_calls=COUNTED_CALLS, graphs=step.programs)
        step.release()
        del step, x, y
        torch.cuda.empty_cache()
    plain = rows["plain"]
    for key, r in rows.items():
        r["loss_rel_diffs"] = [_rel_diff(a, p) for a, p in
                               zip(r["losses"], plain["losses"])]
        r["ok"] = bool(max(r["loss_rel_diffs"]) == 0 and r["graphs"] == 1)
        r["slowdown"] = r["step_ms"] / plain["step_ms"]
        r["peak_vs_plain"] = (r["peak_above_base_bytes"]
                              / plain["peak_above_base_bytes"])
    emit({"remat": dict(model=kind, batch=b, seq=s, step_seeds=STEP_SEEDS[:2],
                        rows=list(rows.values()))})
    bad = [r for r in rows.values() if not r["ok"]]
    if bad:
        fail(f"a {kind} remat step disagrees with the plain step: {bad}")
    del model, w0
    torch.cuda.empty_cache()
    return rows


def ernie_determinism_phase(torch, pt):
    """ERNIE-base's eager O1 step from one state and one step seed twice:
    the parameters whose gradients differ between the two (before
    F.embedding's backward ran in torch's deterministic mode: the
    position and token-type embeddings, whose rows repeat 48 and 24,576
    times a step); the ops torch names under
    use_deterministic_algorithms(True, warn_only=True); and whether the
    step is bit-reproducible under that mode. Fails unless the plain
    step is bit-reproducible, which the bit-equal checks of ERNIE's
    captured and remat steps rely on."""
    import warnings
    model = _train_model(pt, "ernie")
    step, x, y, _, _ = _train_step(torch, "ernie", model)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    s0 = step.state_dict()

    def grads(seed):
        step.set_state_dict(s0)
        loss = float(step.eager_step(x, y, seed=seed))
        return loss, [None if p.grad is None else p.grad.clone()
                      for p in step.params]

    (la, ga), (lb, gb) = grads(STEP_SEEDS[0]), grads(STEP_SEEDS[0])
    differ = [dict(param=n, max_abs_diff=float((a - b).abs().max()))
              for n, a, b in zip(names, ga, gb)
              if a is not None and not torch.equal(a, b)]
    del ga, gb
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            (lc, gc), (ld, gd) = (grads(STEP_SEEDS[0]),
                                  grads(STEP_SEEDS[0]))
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message)[:160] for w in caught
                  if "deterministic" in str(w.message)})
    det_equal = all((a is None and b is None) or torch.equal(a, b)
                    for a, b in zip(gc, gd))
    row = dict(loss_a=la, loss_b=lb, params_differing=differ,
               bit_reproducible=not differ and la == lb,
               nondeterministic_ops=ops,
               reproducible_in_deterministic_mode=bool(det_equal
                                                       and lc == ld),
               deterministic_mode_losses=[lc, ld])
    emit({"ernie_determinism": row})
    step.release()
    del step, model, gc, gd, s0
    torch.cuda.empty_cache()
    if not row["bit_reproducible"]:
        fail(f"ERNIE-base's eager step is not bit-reproducible: {row}")


# -- the elastic plane: checkpoints, the launcher, chaos -------------------------
# GPT-2 small training under `launch --elastic` and the drill worker: the
# steps of a run, an async save every ELASTIC_EVERY of them, and the runs:
# (name, chaos mode, the step it strikes at)
ELASTIC_STEPS, ELASTIC_EVERY = 7, 2
ELASTIC_RUNS = [("control", None, None), ("kill", "kill", 5),
                ("corrupt_ckpt", "corrupt_ckpt", 6),
                ("numeric", "nan_grad", 5)]
# the numeric run's worker arms the sentry (--sentry) with this
# fingerprint period: a checkpoint is stamped healthy after
# ELASTIC_PROBE + 1 clean steps (step 3's is, step 1's is not)
ELASTIC_PROBE = 2
ELASTIC_TIMEOUT = 420
ELASTIC_WORKER = os.path.join("paddle_tpu_torch", "distributed",
                              "elastic_worker.py")
ELASTIC_MODEL = ("gpt2", "cuda")    # the worker's --model and --device
# the serving fleet: SERVE_CONFIG's ladder plus the 256 bucket that
# requeue needs (every resumable prefix, up to max_total_tokens - 1)
FLEET_CONFIG = dict(SERVE_CONFIG, prefill_buckets=(32, 64, 128, 256))
FLEET_FAULT_TICK, FLEET_STALL_TICKS = 5, 4
FLEET_QUEUE_HIGH, FLEET_SHED_DEPTH = 4, 16
FLEET_MEMORY_SLACK = 64 << 20


def _elastic_start(name, mode, at, tmp):
    """Start one `launch --elastic` run of the drill worker on GPT-2
    small at GPT_TRAIN_BATCH in a process group of its own (the launcher
    and its workers), its output into files under tmp."""
    ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
    env = dict(os.environ, PYTHONPATH=REPO,
               PD_ELASTIC_DIR=os.path.join(tmp, "receipts"),
               PD_FR_DIR=os.path.join(tmp, "flight"))
    for k in ("PD_CHAOS_MODE", "PD_CHAOS_STEP", "PD_CHAOS_RANK",
              "PD_CHAOS_EVERY"):
        env.pop(k, None)
    if mode:
        env.update(PD_CHAOS_MODE=mode, PD_CHAOS_STEP=str(at),
                   PD_CHAOS_RANK="0")
    b, s = GPT_TRAIN_BATCH
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--elastic", "--heartbeat_timeout", "120",
           "--heartbeat_startup_timeout", "600", "--restart_backoff", "0.1",
           "--dump_grace", "0.5", ELASTIC_WORKER, "--ckpt-dir", ckpt,
           "--out-dir", out, "--model", ELASTIC_MODEL[0],
           "--device", ELASTIC_MODEL[1],
           "--steps", str(ELASTIC_STEPS), "--ckpt-every", str(ELASTIC_EVERY),
           "--batch", str(b), "--seq", str(s)]
    if mode == "nan_grad":
        cmd += ["--sentry", "--sentry-probe-every", str(ELASTIC_PROBE)]
    logs = [open(os.path.join(tmp, f"launch.{k}"), "w")
            for k in ("out", "err")]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=logs[0], stderr=logs[1],
                            start_new_session=True)
    return dict(name=name, mode=mode, at=at, tmp=tmp, proc=proc, logs=logs,
                t0=time.perf_counter(), rc=None, seconds=None)


def _elastic_wait(started, timeout):
    """Wait for every started run; a group still running after timeout
    seconds is killed (rc 124). Sets each run's rc and seconds."""
    import signal
    deadline = time.perf_counter() + timeout
    while any(r["rc"] is None for r in started):
        for r in started:
            if r["rc"] is None and r["proc"].poll() is not None:
                r["rc"] = r["proc"].returncode
                r["seconds"] = time.perf_counter() - r["t0"]
        if time.perf_counter() > deadline:
            for r in started:
                if r["rc"] is None:
                    os.killpg(r["proc"].pid, signal.SIGKILL)
                    r["proc"].wait()
                    r["rc"] = 124
                    r["seconds"] = time.perf_counter() - r["t0"]
        time.sleep(0.2)
    for r in started:
        for f in r["logs"]:
            f.close()


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _elastic_result(run):
    """A finished run's incarnations, receipts, progress lines and final
    manifest (its temporary directory, checkpoints included, is removed
    after); None and the end of its stderr if the launch failed."""
    import glob
    import shutil
    tmp = run["tmp"]
    out = os.path.join(tmp, "out")
    if run["rc"] != 0:
        with open(os.path.join(tmp, "launch.err")) as f:
            err = f.read()[-3000:]
        shutil.rmtree(tmp, ignore_errors=True)
        return None, err
    incs = sorted((json.load(open(f)) for f in glob.glob(
        os.path.join(out, "inc*_slot0.json"))),
        key=lambda d: d["incarnation"])
    receipts = [json.load(open(f)) for f in sorted(glob.glob(
        os.path.join(tmp, "receipts", "receipt_*.json")))]
    progress = _jsonl(os.path.join(out, "progress_slot0.jsonl"))
    with open(os.path.join(tmp, "ckpt", "slot0.pkl.manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(name=run["name"], mode=run["mode"], at=run["at"],
                seconds=run["seconds"], incs=incs, receipts=receipts,
                progress=progress, manifest=manifest), None


def _elastic_row(run, control):
    """The run's line and its gate failures against the control run."""
    bad = []
    incs, name = run["incs"], run["name"]
    want_incs = 1 if run["mode"] is None else 2
    if len(incs) != want_incs or not incs[-1]["done"]:
        bad.append(f"{name}: {len(incs)} incarnations (done "
                   f"{[i['done'] for i in incs]}), expected {want_incs}")
    want_rc = 0 if run["mode"] is None else 1
    verdict = "numeric" if run["mode"] == "nan_grad" else "crash"
    if len(run["receipts"]) != want_rc or any(
            r["verdict"]["kind"] != verdict for r in run["receipts"]):
        bad.append(f"{name}: receipts "
                   f"{[(r['action'], r['verdict']) for r in run['receipts']]}")
    per_layer = GPT_TRAIN["num_layers"]
    for inc in incs:
        want = {k: per_layer for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                       "flash_attn_bwd_dkv")}
        if inc["graphs"] != 1 or inc["sentinel_events"] or \
                inc["warmup_launches"] != want:
            bad.append(f"{name} incarnation {inc['incarnation']}: graphs "
                       f"{inc['graphs']}, sentinel events "
                       f"{inc['sentinel_events']}, warm-up launches "
                       f"{inc['warmup_launches']}")
    resumed = incs[-1] if len(incs) > 1 else None
    row = dict(run=name, chaos=run["mode"], chaos_step=run["at"],
               seconds=run["seconds"], incarnations=len(incs),
               receipts=[dict(action=r["action"], verdict=r["verdict"],
                              backoff_s=r["backoff_s"])
                         for r in run["receipts"]])
    if resumed is not None:
        cands = resumed["candidate_steps"]
        # the newest intact candidate: the primary after a kill, the
        # one past the corrupted primary after corrupt_ckpt; after the
        # numeric fault the newest health-stamped one (the fault's own
        # step was committed stamped unhealthy)
        want_at = cands[0] if run["mode"] == "kill" else (
            cands[1] if len(cands) > 1 else None)
        if run["mode"] == "nan_grad":
            fault = incs[0].get("fault") or {}
            want_at = ELASTIC_PROBE + 1
            row_fault = dict(
                step=fault.get("step"), reason=fault.get("reason"),
                health=fault.get("health"),
                anomalies=[a.get("kind") for a in fault.get("anomalies",
                                                            [])],
                require_healthy=resumed["require_healthy"],
                resume_health=resumed["resume_health"])
            if fault.get("step") != run["at"] or \
                    "nonfinite" not in str(fault.get("reason")) or \
                    (fault.get("health") or {}).get("healthy") is not False \
                    or not resumed["require_healthy"] or \
                    not (resumed["resume_health"] or {}).get("healthy") \
                    or cands[0] != run["at"]:
                bad.append(f"{name}: fault {row_fault}, candidates {cands}")
        if resumed["resume_step"] is None or \
                resumed["resume_step"] != want_at:
            bad.append(f"{name}: resumed from {resumed['resume_step']}, "
                       f"candidates on disk {cands}")
        died = [p for p in run["progress"] if p["inc"] == 0]
        back = [p for p in run["progress"] if p["inc"] == 1
                and p["phase"] == "end"]
        if run["mode"] == "nan_grad":
            row["fault"] = row_fault
        row.update(resume_step=resumed["resume_step"],
                   candidate_steps=cands,
                   restore_ms=resumed["restore_ms"],
                   died_at_step=died[-1]["step"],
                   kill_to_first_resumed_step_s=(
                       back[0]["t"] - died[-1]["t"] if back else None))
    losses = {}
    for inc in incs:
        losses.update(inc["losses"])
    ctrl = control["incs"][0]["losses"] if control else losses
    after = sorted(int(k) for k in losses
                   if resumed is None or int(k) > resumed["resume_step"])
    row["losses_after_resume_equal"] = all(
        losses[str(k)] == ctrl[str(k)] for k in after)
    row["losses"] = [losses[str(k)] for k in range(ELASTIC_STEPS)]
    if not row["losses_after_resume_equal"]:
        bad.append(f"{name}: losses {row['losses']} against the control's "
                   f"{[ctrl[str(k)] for k in range(ELASTIC_STEPS)]}")
    if control is not None:
        # the sentry's own state (its step counter and fingerprint in
        # strategy_state) is not the control's: the rest must be equal
        own = {k: v for k, v in run["manifest"].items()
               if "sentry_" not in k}
        row["sentry_leaves"] = len(run["manifest"]) - len(own)
        run = dict(run, manifest=own)
        same = sorted(k for k in run["manifest"]
                      if run["manifest"][k] == control["manifest"].get(k))
        row["manifest_leaves"] = len(run["manifest"])
        row["manifest_leaves_equal"] = len(same)
        if len(same) != len(control["manifest"]) or \
                len(run["manifest"]) != len(control["manifest"]):
            diff = sorted(set(run["manifest"]) - set(same))[:5]
            bad.append(f"{name}: final manifest differs from the control's "
                       f"at {diff}")
    row["per_incarnation"] = [dict(
        incarnation=i["incarnation"], resume_step=i["resume_step"],
        restore_ms=i["restore_ms"], graphs=i["graphs"],
        captures=i["captures"], replays=i["replays"],
        sentinel_events=i["sentinel_events"],
        warmup_launches=i["warmup_launches"],
        goodput_checkpoint_fraction=i["goodput"]["checkpoint_fraction"],
        goodput=i["goodput"], saves=i["saves"]) for i in incs]
    return row, bad


def elastic_train_phase(torch):
    """GPT-2 small (GPT_TRAIN, O1 bf16, AdamW) at GPT_TRAIN_BATCH through
    `python -m paddle_tpu_torch.distributed.launch --elastic` and the
    drill worker: a control run, a kill at step 5, a corrupt_ckpt at
    step 6 and the numeric case (the worker's --sentry, a NaN in rank
    0's gradients at step 5: the sentry's fault at step 5, exit 13, the
    step committed stamped unhealthy, a NUMERIC verdict, and the relaunch
    with PD_ROLLBACK_HEALTHY=1 resuming from the newest healthy stamp,
    step 3, bit-equal to the control after it), each with an async save
    every ELASTIC_EVERY steps into a temporary directory. The four runs
    go side by side on the one card, each with its own launcher, worker
    and directory; a run's seconds are its own wall time among them."""
    import signal
    import tempfile
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    started = []
    try:
        for name, mode, at in ELASTIC_RUNS:
            started.append(_elastic_start(
                name, mode, at, tempfile.mkdtemp(prefix="pd_elastic_")))
        _elastic_wait(started, ELASTIC_TIMEOUT)
    except BaseException:
        for r in started:
            if r["proc"].poll() is None:
                os.killpg(r["proc"].pid, signal.SIGKILL)
        raise
    wall_s = time.perf_counter() - t0
    runs, failed = {}, []
    for r in started:
        runs[r["name"]], err = _elastic_result(r)
        if err is not None:
            failed.append(f"{r['name']}: the launch exited {r['rc']}: "
                          f"{err}")
    if failed:
        fail("elastic_train: " + "; ".join(failed))
    control = runs["control"]
    rows, bad = [], []
    for name, _, _ in ELASTIC_RUNS:
        row, b = _elastic_row(runs[name],
                              None if name == "control" else control)
        rows.append(row)
        bad += b
    saves = [s for r in rows for i in r["per_incarnation"]
             for s in i["saves"]]
    emit({"elastic_train": dict(
        card=nvidia_smi(), model="GPT-2 small", batch=GPT_TRAIN_BATCH,
        amp="O1 bfloat16", dropout=GPT_TRAIN["dropout"],
        steps=ELASTIC_STEPS, save_every=ELASTIC_EVERY,
        runs_side_by_side=len(started), wall_s=wall_s,
        checkpoint_bytes=saves[0]["bytes"] if saves else None,
        save_block_ms=[s["block_ms"] for s in saves],
        save_join_ms=[s["join_ms"] for s in saves],
        save_write_ms=[s["write_ms"] for s in saves],
        runs=rows)})
    if bad:
        fail("elastic_train: " + "; ".join(bad))
    return rows


class _ChaosEnv:
    """with _ChaosEnv(mode, tick, replica): the PD_CHAOS_* plan armed for
    the fleet inside, disarmed after."""

    KEYS = ("PD_CHAOS_MODE", "PD_CHAOS_STEP", "PD_CHAOS_RANK",
            "PD_CHAOS_STALL_S")

    def __init__(self, mode, tick, replica):
        self.env = dict(PD_CHAOS_MODE=mode, PD_CHAOS_STEP=str(tick),
                        PD_CHAOS_RANK=str(replica), PD_CHAOS_STALL_S="600")

    def __enter__(self):
        from paddle_tpu_torch.distributed import chaos
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(self.env)
        chaos.reset_plan_cache()

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import chaos
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        chaos.reset_plan_cache()


def _fleet_f32(model, tmp, **fc):
    from paddle_tpu_torch.serving import (FleetConfig, ServingConfig,
                                          ServingFleet, ServingSLO)
    return ServingFleet(
        model, ServingConfig(**dict(FLEET_CONFIG, dtype=None)),
        ServingSLO(p99_ttft_ms=1e9),
        FleetConfig(**dict(dict(replicas=2, min_replicas=1, max_replicas=2,
                                autoscale=False, backoff_base=0.0,
                                stall_ticks=FLEET_STALL_TICKS,
                                receipts_dir=tmp), **fc)))


def _fleet_staggered(fleet, prompts, news):
    """_staggered's admission pattern through the fleet; drained.
    Returns the fleet requests in submit order."""
    frs = [fleet.submit(prompts[0], news[0])]
    fleet.step()
    fleet.step()
    frs.append(fleet.submit(prompts[1], news[1]))
    fleet.step()
    frs += [fleet.submit(prompts[i], news[i]) for i in (2, 3)]
    fleet.step()
    frs += [fleet.submit(prompts[i], news[i]) for i in (4, 5)]
    fleet.run_until_drained()
    return frs


def _fleet_graphs(fleet):
    return {slot: dict(graphs=rep.engine.executable_count(),
                       expected=rep.engine.expected_executables,
                       captures=rep.engine.programs.captures,
                       warmup_s=rep.warmup_s)
            for slot, rep in sorted(fleet._replicas.items())
            if rep.engine is not None}


def _fleet_fault_run(torch, model, parity, mode, tmp):
    """The f32 fleet (2 replicas) over the parity trace with `mode`
    (kill or stall) struck on replica 1 at FLEET_FAULT_TICK: every
    request finishes, at least one is requeued, the streams agree with
    solo generate's (streams_agree), and after the eviction the card's
    allocated bytes are back within FLEET_MEMORY_SLACK of their level
    before replica 1 was spawned."""
    fleet = _fleet_f32(model, tmp)
    graphs = _fleet_graphs(fleet)
    before = fleet._replicas[1].mem_before_spawn
    with _ChaosEnv(mode, FLEET_FAULT_TICK, 1):
        frs = _fleet_staggered(fleet, parity["prompts"], parity["news"])
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    agree = streams_agree([fr.emitted for fr in frs], parity["want"],
                          parity["gaps"])
    row = dict(fault=mode, tick=FLEET_FAULT_TICK, replica=1,
               finished=sum(fr.done for fr in frs), requests=len(frs),
               requeued_total=fleet.requeued_total,
               evictions=[fr.evictions for fr in frs],
               episodes=[(e["action"], e["ranks"], e["verdict"]["kind"])
                         for e in fleet.episodes],
               live_replicas=fleet.live_replicas(), graphs=graphs,
               recompile_events=fleet.recompile_events(), streams=agree,
               streams_agree=all(r["ok"] for r in agree),
               memory_before_spawn=before, memory_after_eviction=after,
               memory_back=after - before <= FLEET_MEMORY_SLACK)
    bad = []
    if row["finished"] != len(frs) or fleet.requeued_total < 1:
        bad.append(f"{mode}: {row['finished']}/{len(frs)} finished, "
                   f"{fleet.requeued_total} requeued")
    if not row["streams_agree"]:
        bad.append(f"{mode}: streams differ from solo generate: {agree}")
    if not row["memory_back"]:
        bad.append(f"{mode}: {after - before} bytes more allocated after "
                   "the eviction than before the replica's spawn")
    want_kind = "crash" if mode == "kill" else "hang"
    if not any(k == want_kind and 1 in r for _, r, k in row["episodes"]):
        bad.append(f"{mode}: episodes {row['episodes']}")
    if any(g["graphs"] != g["expected"] for g in graphs.values()) or \
            row["recompile_events"]:
        bad.append(f"{mode}: graphs {graphs}, sentinel events "
                   f"{row['recompile_events']}")
    return row, bad


def _fleet_swap_run(torch, pt, model, parity, tmp):
    """A second GPT-2 small weight set (seed SEED + 7) written by
    save_sharded, swapped into the f32 fleet from the checkpoint: one
    replica flips per tick, no capture, no sentinel event; the streams
    after agree with a solo engine's on the new weights. Then a
    corrupt_swap drill: the swap aborts with a receipt and the weights
    in service stay as they were."""
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.generation import _gpt_params
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    pt.seed(SEED + 7)
    other = GPTForCausalLM(GPTConfig(**GPT2), device="cuda").eval()
    path = os.path.join(tmp, "weights")
    t0 = time.perf_counter()
    ck.save_sharded({"params": _gpt_params(other)}, path)
    save_s = time.perf_counter() - t0
    solo = ServingEngine(other, ServingConfig(**dict(FLEET_CONFIG,
                                                     dtype=None))).warmup()
    want = _staggered(solo, parity["prompts"], parity["news"])
    gaps = [_stream_gaps(torch, other, p, w)
            for p, w in zip(parity["prompts"], want)]
    solo.release()
    del solo, other
    torch.cuda.empty_cache()

    fleet = _fleet_f32(model, tmp)
    captures0 = sum(g["captures"] for g in _fleet_graphs(fleet).values())
    t0 = time.perf_counter()
    staged = fleet.swap_weights(checkpoint_path=path)
    stage_s = time.perf_counter() - t0
    pending = []
    while fleet._standby is not None:
        fleet.step()
        pending.append(len(fleet._flip_pending))
    captures1 = sum(g["captures"] for g in _fleet_graphs(fleet).values())
    frs = _fleet_staggered(fleet, parity["prompts"], parity["news"])
    agree = streams_agree([fr.emitted for fr in frs], want, gaps)
    wte = {s: r.engine.params["wte"].clone()
           for s, r in fleet._replicas.items()}
    with _ChaosEnv("corrupt_swap", fleet._tick + 1, 0):
        fleet.step()
    aborted = fleet.swap_weights(checkpoint_path=path) is False
    kept = all(torch.equal(wte[s], r.engine.params["wte"])
               for s, r in fleet._replicas.items())
    row = dict(staged=staged, checkpoint_save_s=save_s, stage_s=stage_s,
               flips_pending_per_tick=pending, swaps=fleet.swaps_total,
               captures_before=captures0, captures_after=captures1,
               recompile_events=fleet.recompile_events(), streams=agree,
               streams_agree=all(r["ok"] for r in agree),
               corrupt_swap_aborted=aborted,
               swaps_aborted=fleet.swaps_aborted,
               old_weights_kept=kept,
               last_episode=fleet.episodes[-1]["action"])
    bad = []
    if not staged or fleet.swaps_total != 1 or pending != list(
            range(fleet.fleet.replicas - 1, -1, -1)):
        bad.append(f"swap: staged {staged}, swaps {fleet.swaps_total}, "
                   f"flips pending per tick {pending}")
    if captures1 != captures0 or row["recompile_events"]:
        bad.append(f"swap: captures {captures0} -> {captures1}, sentinel "
                   f"events {row['recompile_events']}")
    if not row["streams_agree"]:
        bad.append(f"swap: streams differ from the new weights' engine: "
                   f"{agree}")
    if not (aborted and fleet.swaps_aborted == 1 and kept
            and row["last_episode"] == "swap_aborted"):
        bad.append(f"corrupt_swap: aborted {aborted}, swaps_aborted "
                   f"{fleet.swaps_aborted}, weights kept {kept}")
    return row, bad


def _fleet_overload_run(torch, model, tmp):
    """The bf16 fleet from one replica (up to two) under the serve_trace
    requests as one burst, every other one in the batch class, at
    queue_high FLEET_QUEUE_HIGH and shed depth FLEET_SHED_DEPTH:
    scale_up spawns a replica whose graphs equal the expected count,
    the burst drains with every request finished or shed, and idle
    ticks scale down and retire the spawned replica, after which the
    card's allocated bytes are back within FLEET_MEMORY_SLACK."""
    import numpy as np
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import (FleetConfig, ServingConfig,
                                          ServingFleet, ServingSLO)
    vocab = GPT2["vocab_size"]
    fleet = ServingFleet(
        model, ServingConfig(**FLEET_CONFIG),
        ServingSLO(queue_high=FLEET_QUEUE_HIGH, queue_low=0,
                   p99_ttft_ms=1e9, shed_queue_depth=FLEET_SHED_DEPTH),
        FleetConfig(replicas=1, min_replicas=1, max_replicas=2,
                    autoscale=True, scale_cooldown_s=0.0,
                    receipts_dir=tmp))
    counter = metrics.counter("cuda_graph.captures_total", _always=True,
                              program="serving")
    prompts, news = serve_trace(np, vocab)
    seen = {id(rep) for rep in fleet._replicas.values()}
    spawns = []
    t0 = time.perf_counter()
    frs = [fleet.submit(p, n, cls="batch" if i % 2 else "interactive")
           for i, (p, n) in enumerate(zip(prompts, news))]
    ticks = 0
    while fleet.has_work():
        c0 = counter.value()
        fleet.step()
        ticks += 1
        for slot, rep in fleet._replicas.items():
            if id(rep) not in seen:
                seen.add(id(rep))
                if rep.engine is not None:
                    spawns.append(dict(
                        slot=slot, tick=ticks, rep=rep,
                        graphs=rep.engine.executable_count(),
                        expected=rep.engine.expected_executables,
                        captures_counted=counter.value() - c0,
                        warmup_s=rep.warmup_s))
        if ticks > 20000:
            fail("the fleet's overload burst did not drain")
    secs = time.perf_counter() - t0
    for _ in range(50):
        if 1 not in fleet._replicas:
            break
        fleet.step()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    served = [fr for fr in frs if not fr.shed]
    ttft = np.array([(fr.first_token_ts - fr.arrival) * 1e3
                     for fr in served])
    tokens = sum(len(fr.emitted) for fr in served)
    last = spawns[-1]["rep"] if spawns else None
    row = dict(requests=len(frs), shed=fleet.shed_total,
               finished=sum(1 for fr in served
                            if fr.finish_reason in ("length", "eos")
                            and len(fr.emitted) == fr.max_new_tokens),
               dropped=sum(1 for fr in frs
                           if fr.finish_reason == "dropped"),
               evictions=sum(fr.evictions for fr in frs), ticks=ticks,
               seconds=secs, generated_tokens=tokens,
               tokens_per_s=tokens / secs,
               ttft_ms_p50=float(np.percentile(ttft, 50)),
               ttft_ms_p99=float(np.percentile(ttft, 99)),
               episodes=[(e["action"], e["ranks"]) for e in fleet.episodes],
               spawns=[{k: v for k, v in s.items() if k != "rep"}
                       for s in spawns],
               live_replicas=fleet.live_replicas(),
               memory_before_spawn=None if last is None
               else last.mem_before_spawn,
               memory_after_retire=after)
    row["memory_back"] = last is not None and \
        after - last.mem_before_spawn <= FLEET_MEMORY_SLACK
    bad = []
    if row["finished"] + row["shed"] != len(frs) or row["dropped"] or \
            row["evictions"]:
        bad.append(f"overload: {row['finished']} finished + {row['shed']} "
                   f"shed of {len(frs)}, {row['dropped']} dropped, "
                   f"{row['evictions']} evictions")
    actions = [a for a, _ in row["episodes"]]
    if "scale_up" not in actions or "scale_down" not in actions or \
            fleet.live_replicas() != [0]:
        bad.append(f"overload: episodes {row['episodes']}, live "
                   f"{fleet.live_replicas()}")
    if not spawns or any(s["graphs"] != s["expected"]
                         or s["captures_counted"] != s["expected"]
                         for s in spawns):
        bad.append(f"overload: spawned replicas' graphs {row['spawns']}")
    if not row["memory_back"]:
        bad.append(f"overload: {after} bytes allocated after the retire, "
                   f"{row['memory_before_spawn']} before the spawn")
    return row, bad


def fleet_phase(torch, pt, model, serving_row, parity):
    """The serving fleet on GPT-2 small at FLEET_CONFIG: f32 parity under
    a kill and a stall of replica 1, a hot swap from a checkpoint and a
    corrupt_swap, and the bf16 overload burst with autoscale and
    shedding; tokens/s and TTFT beside the `serving` phase's."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="pd_fleet_")
    bad = []
    faults = []
    for mode in ("kill", "stall"):
        row, b = _fleet_fault_run(torch, model, parity, mode, tmp)
        faults.append(row)
        bad += b
        torch.cuda.empty_cache()
    swap, b = _fleet_swap_run(torch, pt, model, parity, tmp)
    bad += b
    torch.cuda.empty_cache()
    over, b = _fleet_overload_run(torch, model, tmp)
    bad += b
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"fleet": dict(
        card=nvidia_smi(), config=FLEET_CONFIG, faults=faults, swap=swap,
        overload=over,
        beside_serving=dict(
            fleet_tokens_per_s=over["tokens_per_s"],
            fleet_ttft_ms_p50=over["ttft_ms_p50"],
            fleet_ttft_ms_p99=over["ttft_ms_p99"],
            serving_tokens_per_s=serving_row["tokens_per_s"],
            serving_ttft_ms_p50=serving_row["ttft_ms_p50"],
            serving_ttft_ms_p99=serving_row["ttft_ms_p99"],
            note="the fleet takes the 48 requests as one burst on 1-2 "
                 "replicas; `serving` takes them in waves of 8 every 4 "
                 "steps on one engine"))})
    if bad:
        fail("fleet: " + "; ".join(bad))


# -- the load generator (loadgen) -------------------------------------------------
# tools/serving_bench.py:262-269's defaults: 40 requests, seed 0, 60/s
LOADGEN_TRACE = dict(n_requests=40, seed=0, rate_rps=60.0)
LOADGEN_MIX = {"interactive": 0.5, "batch": 0.5}
LOADGEN_STATIC_BATCH = 4


def _loadgen_row(stats):
    return dict(
        tokens_per_s=stats["sustained_tokens_per_sec"],
        ttft_ms_p50=stats["ttft_ms"]["p50"],
        ttft_ms_p99=stats["ttft_ms"]["p99"],
        per_token_ms_p50=stats["per_token_ms"]["p50"],
        per_token_ms_p99=stats["per_token_ms"]["p99"],
        requests=stats["requests"], total_new_tokens=stats["total_new_tokens"],
        span_s=stats["span_s"])


def loadgen_phase(torch, pt, model):
    """paddle_tpu_torch/serving/loadgen.py's three replays of one
    synthetic trace on GPT-2 small in bf16: the engine, static batches
    (cold, then warm) and a 2-replica fleet."""
    import shutil
    import tempfile
    from paddle_tpu_torch.serving import (FleetConfig, ServingConfig,
                                          ServingEngine, ServingFleet,
                                          ServingSLO, loadgen)
    vocab = GPT2["vocab_size"]
    trace = loadgen.synthetic_trace(vocab_size=vocab, **LOADGEN_TRACE)
    bad = []
    t_phase = time.perf_counter()
    # the engine
    eng = ServingEngine(model, ServingConfig(**SERVE_CONFIG))
    eng.warmup()
    finished = []
    step = eng.step

    def counted_step():
        done = step()
        finished.extend(done)
        return done
    eng.step = counted_step
    stats = loadgen.replay_continuous(eng, trace)
    short = [r.rid for r in finished if len(r.out) != r.max_new_tokens]
    engine = dict(_loadgen_row(stats), executables=stats["executables"],
                  expected_executables=stats["expected_executables"],
                  recompile_events=stats["recompile_events"],
                  peak_pages_live=stats["peak_pages_live"])
    if stats["recompile_events"] or \
            stats["executables"] != stats["expected_executables"]:
        bad.append(f"engine leg: {engine}")
    if short or len(finished) != len(trace):
        bad.append(f"engine leg: {len(finished)} finished of {len(trace)}, "
                   f"short budgets {short}")
    eng.release()
    del eng
    torch.cuda.empty_cache()
    # static batches through generate, cold then warm
    static = {}
    for leg in ("cold", "warm"):
        st = loadgen.replay_static(model, trace,
                                   batch_size=LOADGEN_STATIC_BATCH,
                                   dtype="bfloat16")
        static[leg] = dict(_loadgen_row(st),
                           compiled_signatures=st["compiled_signatures"],
                           program_captures=st["program_captures"])
        if st["requests"] != len(trace):
            bad.append(f"static {leg}: {st['requests']} requests")
    if static["warm"]["program_captures"] != 0 or \
            static["cold"]["program_captures"] != \
            static["cold"]["compiled_signatures"]:
        bad.append(f"static: captures {static}")
    # the fleet on the staggered trace
    tmp = tempfile.mkdtemp(prefix="pd_loadgen_")
    mixed = loadgen.synthetic_trace(vocab_size=vocab, class_mix=LOADGEN_MIX,
                                    **LOADGEN_TRACE)
    fleet = ServingFleet(model, ServingConfig(**FLEET_CONFIG), ServingSLO(),
                         FleetConfig(replicas=2, min_replicas=1,
                                     max_replicas=2, autoscale=False,
                                     receipts_dir=tmp))
    fstats, ffinished, fshed = loadgen.replay_fleet(fleet, mixed)
    fshort = [fr.rid for fr in ffinished
              if fr.finish_reason in ("length", "eos")
              and len(fr.emitted) != fr.max_new_tokens]
    fleet_row = dict(_loadgen_row(fstats), shed=fstats["shed"],
                     dropped_requests=fstats["dropped_requests"],
                     per_class_ttft_ms=fstats.get("per_class_ttft_ms"),
                     summary=fstats["fleet"])
    if fstats["dropped_requests"] or fshort or \
            len(ffinished) + len(fshed) != len(mixed):
        bad.append(f"fleet leg: {len(ffinished)} finished + {len(fshed)} "
                   f"shed of {len(mixed)}, dropped "
                   f"{fstats['dropped_requests']}, short budgets {fshort}")
    for rep in fleet._replicas.values():
        if rep.engine is not None:
            rep.engine.release()
    del fleet
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"loadgen": dict(
        card=nvidia_smi(), trace=dict(LOADGEN_TRACE, vocab=vocab,
                                      class_mix_fleet=LOADGEN_MIX),
        config=SERVE_CONFIG, fleet_config=FLEET_CONFIG, engine=engine,
        static=static, fleet=fleet_row,
        seconds=time.perf_counter() - t_phase)})
    if bad:
        fail("loadgen: " + "; ".join(bad))


# -- data-parallel training (dp_train) -----------------------------------------------
DP_COMPRESS = ("bf16", "int8_ef")
DP_TIMED = 10
# the planner phases: timed replays a run; the card's memory for
# MeshPlan.auto (an H100 80GB's)
PLAN_TIMED = 5
HBM_BYTES = 80e9


def _collectives_identity(torch, c):
    """Every collective of distributed/collective.py on card tensors at
    world size 1 (NCCL), against what it must give: the identity."""
    x = torch.randn(64, 48, device="cuda")
    got = {}
    for op in ("sum", "max", "min", "avg", "prod"):
        got["all_reduce_" + op] = (c.all_reduce(x.clone(), op=op), x)
    got["all_gather"] = (c.all_gather(x), x[None])
    lst = []
    c.all_gather(lst, x)
    got["all_gather_list"] = (torch.stack(lst), x[None])
    got["broadcast"] = (c.broadcast(x.clone(), src=0), x)
    got["reduce"] = (c.reduce(x.clone(), dst=0), x)
    got["scatter"] = (c.scatter(x.clone()), x)
    got["reduce_scatter"] = (c.reduce_scatter(x.clone()), x)
    got["all_to_all"] = (c.all_to_all(x.clone()), x)
    got["all_to_all_cat1"] = (c.all_to_all(x.clone(), split_axis=0,
                                           concat_axis=1), x)
    got["p2p_shift"] = (c.p2p_shift(x, shift=1), x)
    c.send(x, dst=0)
    got["send_recv"] = (c.recv(torch.zeros_like(x), src=0), x)
    c.barrier()
    torch.cuda.synchronize()
    return {k: bool(torch.equal(a, b)) for k, (a, b) in got.items()}


def _timed_replays(torch, step, x, y, n=DP_TIMED):
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(x, y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def dp_train_phase(torch, pt, fa):
    """GPT-2 small 8x1024 O1 through TrainStep(mesh={"dp": 1}) on a
    one-rank NCCL process group, against the same step without a mesh;
    then the comm planner's bf16 and int8_ef syncs; then the collectives
    at world size 1. Returns the row (its `launches`: the first call's
    warm-up and a profiled replay, counted as captured_train counts)."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as c
    from paddle_tpu_torch.distributed.comm import CommConfig
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        make_comm_sync_transform
    from paddle_tpu_torch.observability import metrics
    t_phase = time.perf_counter()
    env = dist.init_parallel_env()
    try:
        if tdist.get_backend() != "nccl" or env.world_size != 1:
            fail(f"dp_train: backend {tdist.get_backend()}, world "
                 f"{env.world_size}")
        mesh = dist.get_mesh()
        identity = _collectives_identity(torch, c)
        # the plain step and the dp step, from one start (SEED)
        plain_model = _train_model(pt, "gpt")
        plain, x, y, (b, s), layers = _train_step(torch, "gpt", plain_model)
        dp_model = _train_model(pt, "gpt")
        _zero(fa)
        step, _, _, _, _ = _train_step(torch, "gpt", dp_model, mesh=mesh)
        losses = {"dp": [], "plain": []}
        for sd in STEP_SEEDS:
            losses["dp"].append(float(step(x, y, seed=sd)))
            if len(losses["dp"]) == 1:
                warm = dict(step.last_launches)
                wrapper_counts = dict(fa.launches)
            losses["plain"].append(float(plain(x, y, seed=sd)))
        params_equal = _bit_equal(_snapshot(step), _snapshot(plain))
        prof = profile_step(torch, step, x, y)
        _expect_launches("dp gpt", [warm, prof["launches_per_replay"]],
                         layers)
        nccl_per_replay = prof["nccl_launches"] / PROFILED_REPLAYS
        want_nccl = len(step.params) + 1         # the grads and the loss
        dp_ms = _timed_replays(torch, step, x, y)
        plain_ms = _timed_replays(torch, plain, x, y)
        plain.release()
        del plain, plain_model
        torch.cuda.empty_cache()
        comm_rows = {}
        for compress in DP_COMPRESS:
            model = _train_model(pt, "gpt")
            init, fn = make_comm_sync_transform(CommConfig(compress=compress))
            state = init({k: p for k, p in model.named_parameters()
                          if p.requires_grad})
            cstep, _, _, _, _ = _train_step(
                torch, "gpt", model, mesh=mesh, grad_transform=fn,
                strategy_state=state)
            metrics.enable()
            metrics.reset("comm.")
            closs = [float(cstep(x, y, seed=STEP_SEEDS[0]))]
            # the first call runs the body twice: warm-up and capture
            wire = metrics.get("comm.wire_bytes").value() / 2
            metrics.disable()
            closs += [float(cstep(x, y, seed=sd)) for sd in STEP_SEEDS[1:]]
            cms = _timed_replays(torch, cstep, x, y)
            comm_rows[compress] = dict(
                graphs=cstep.programs,
                sentinel_events=cstep.recompile_sentinel.fired,
                losses=closs, loss_change_vs_plain=[
                    a - p for a, p in zip(closs, losses["plain"])],
                step_ms=cms, step_ms_vs_plain_dp=cms / dp_ms,
                wire_bytes_per_step=wire,
                f32_bytes_per_step=4 * sum(p.numel() for p in cstep.params),
                residual_buckets=sum(1 for k in cstep.strategy_state
                                     if k.startswith("residual_")))
            cstep.release()
            del cstep, model
            torch.cuda.empty_cache()
        row = dict(
            card=nvidia_smi(), model="gpt", batch=b, seq=s, amp="O1 bfloat16",
            dropout=0.1, mesh=mesh.shape, backend="nccl",
            world_size=env.world_size, graphs=step.programs,
            sentinel_events=step.recompile_sentinel.fired,
            step_seeds=STEP_SEEDS, losses=losses["dp"],
            plain_losses=losses["plain"],
            losses_bit_equal=losses["dp"] == losses["plain"],
            params_bit_equal=params_equal,
            launches_per_replay=prof["launches_per_replay"],
            launches=_sum_launches([warm, prof["kernel_launches"]]),
            wrapper_counts=wrapper_counts, counted_calls=COUNTED_CALLS,
            nccl_launches_per_replay=nccl_per_replay,
            nccl_expected=want_nccl,
            nccl_kernels=prof["nccl_names"],
            step_ms=dp_ms, plain_step_ms=plain_ms,
            dp_over_plain=dp_ms / plain_ms,
            device_ms_per_step=prof["device_ms"],
            comm=comm_rows, collectives_identity=identity,
            seconds=time.perf_counter() - t_phase)
        step.release()
        del step, dp_model
        torch.cuda.empty_cache()
    finally:
        dist.set_mesh(None)
        tdist.destroy_process_group()
    emit({"dp_train": row})
    bad = []
    if row["graphs"] != 1 or row["sentinel_events"]:
        bad.append(f"graphs {row['graphs']}, sentinel "
                   f"{row['sentinel_events']}")
    if not (row["losses_bit_equal"] and row["params_bit_equal"]):
        bad.append("the dp step is not bit-equal to the plain step")
    if nccl_per_replay != want_nccl:
        bad.append(f"{nccl_per_replay} NCCL kernels a replay, expected "
                   f"{want_nccl}")
    if not all(identity.values()):
        bad.append(f"collectives at world size 1: {identity}")
    for k, r in comm_rows.items():
        if r["graphs"] != 1 or r["sentinel_events"] or \
                not all(math.isfinite(v) for v in r["losses"]):
            bad.append(f"comm {k}: {r}")
    if bad:
        fail("dp_train: " + "; ".join(bad))
    return row


# -- the planner and the parallel forms (item 14a) ----------------------------

class _OneRankGroup:
    """A one-rank NCCL process group (init_parallel_env, as dp_train
    starts it) for the phases inside; the global mesh and the group are
    gone after."""

    def __enter__(self):
        import torch.distributed as tdist
        from paddle_tpu_torch import distributed as dist
        env = dist.init_parallel_env()
        if tdist.get_backend() != "nccl" or env.world_size != 1:
            fail(f"one-rank group: backend {tdist.get_backend()}, world "
                 f"{env.world_size}")
        dist.set_mesh(None)
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist
        from paddle_tpu_torch import distributed as dist
        dist.set_mesh(None)
        tdist.destroy_process_group()


def moe_routing(model):
    """Each MoE layer's share of routed slots dropped in its last forward
    (a replay's, read from the graph's own count)."""
    out = {}
    for i, lyr in enumerate(model.ernie.encoder):
        if getattr(lyr, "use_moe", False):
            kept = float(lyr.moe.last_kept)
            out[f"layer{i}"] = 1.0 - kept / lyr.moe.last_routed
    return out


def moe_train_gates(row):
    """What moe_train must show; a list of the failures (empty: ok)."""
    bad = []
    if row["graphs"] != 1 or row["sentinel_events"]:
        bad.append(f"graphs {row['graphs']}, sentinel "
                   f"{row['sentinel_events']}")
    if row["max_loss_rel_diff"] != 0 or not row["params_bit_equal"]:
        bad.append("replays are not bit-equal to the eager steps")
    want = {k: row["layers"] for k in KERNEL_EVENTS}
    if row["launches_per_replay"] != want:
        bad.append(f"a replay launched {row['launches_per_replay']}, "
                   f"expected {want}")
    if not row["card_vs_cpu_ok"]:
        bad.append("the card disagrees with the CPU")
    if not all(0.0 <= v < 1.0 for v in row["dropped_share"].values()):
        bad.append(f"dropped shares {row['dropped_share']}")
    if row["nccl_launches_per_replay"] != row["nccl_expected"]:
        # one AVG all-reduce a grad and the loss over the one-rank dp
        # axis; the MoE's exchanges skip axes of one rank
        bad.append(f"{row['nccl_launches_per_replay']} NCCL kernels a "
                   f"replay, expected {row['nccl_expected']}")
    return bad


def moe_train_phase(torch, pt, fa, dense):
    """ERNIE-base-MoE (MOE) pretraining at MOE_BATCH, O1 bf16, dropout
    0.1, AdamW, through TrainStep(mesh=, sharding_plan=MeshPlan(dp=1)
    .sharding_plan()) on the one-rank group: captured_train_phase's gates
    (1 graph, 0 sentinel events, the first call and 3 replays bit-equal
    to 4 eager steps, 12 launches of each kernel a replay, counted on the
    card), the share of routed slots each MoE layer dropped, and the
    card against the CPU at 2 layers. `dense`: captured_train's ERNIE
    row of this run, printed beside."""
    from paddle_tpu_torch import distributed as dist
    plan = dist.MeshPlan(dp=1)
    mesh = plan.build_mesh()
    dist.set_mesh(mesh)
    try:
        row, model, step, x, _ = captured_train_phase(
            torch, pt, fa, "ernie_moe", key="moe_train_step", mesh=mesh,
            sharding_plan=plan.sharding_plan())
        routing = moe_routing(model)
        capacity = next(l.moe.last_capacity for l in model.ernie.encoder
                        if getattr(l, "use_moe", False))
        n_params = len(step.params)
        step.release()
        del model, step, x
        torch.cuda.empty_cache()
        cpu = train_cpu_check(torch, pt, fa, moe=True)
    finally:
        dist.set_mesh(None)
    cfg_layers = BASE["num_hidden_layers"]
    out = dict(card=nvidia_smi(), model="ernie_base_moe", **MOE,
               moe_every_n_layers=2, capacity_factor=1.25, aux_weight=0.01,
               batch=row["batch"], seq=row["seq"], layers=cfg_layers,
               capacity=capacity, graphs=row["graphs"],
               sentinel_events=row["sentinel_events"],
               max_loss_rel_diff=row["max_loss_rel_diff"],
               params_bit_equal=row["params_bit_equal"],
               launches_per_replay=row["launches_per_replay"],
               launches=row["launches"],
               nccl_launches_per_replay=row["nccl_launches_per_replay"],
               nccl_expected=n_params + 1, nccl_kernels=row["nccl_kernels"],
               step_ms=row["step_ms"],
               device_ms_per_step=row["device_ms_per_step"],
               idle_share=row["idle_share"],
               tokens_per_s=row["tokens_per_s"], mfu=row["mfu"],
               params_active=row["params"], params_total=row["params_total"],
               peak_memory_bytes=row["peak_memory_bytes"],
               dropped_share=routing, card_vs_cpu_ok=cpu["ok"],
               dense=dict(step_ms=dense["step_ms"],
                          device_ms_per_step=dense["device_ms_per_step"],
                          tokens_per_s=dense["tokens_per_s"],
                          mfu=dense["mfu"],
                          peak_memory_bytes=dense["peak_memory_bytes"]),
               moe_over_dense_step=row["step_ms"] / dense["step_ms"])
    emit({"moe_train": out})
    bad = moe_train_gates(out)
    if bad:
        fail("moe_train: " + "; ".join(bad))
    return out


def _planned_run(torch, pt, **step_kw):
    """ERNIE-base (dense, SEED) through _train_step with step_kw: the
    first call and 3 replays with STEP_SEEDS, then timed replays. Returns
    (losses, params on the card, step ms, graphs, sentinel events, the
    step)."""
    model = _train_model(pt, "ernie")
    step, x, y, _, _ = _train_step(torch, "ernie", model, **step_kw)
    losses = [float(step(x, y, seed=sd)) for sd in STEP_SEEDS]
    params = _snapshot(step)
    ms = _timed_replays(torch, step, x, y, n=PLAN_TIMED)
    nccl = profile_step(torch, step, x, y)["nccl_launches"] \
        / PROFILED_REPLAYS
    out = (losses, params, ms, step.programs,
           step.recompile_sentinel.fired, nccl, len(step.params))
    step.release()
    del step, model
    torch.cuda.empty_cache()
    return out


def plan_train_gates(row):
    bad = []
    for name, r in row["runs"].items():
        if not (r["losses_bit_equal"] and r["params_bit_equal"]):
            bad.append(f"{name} is not bit-equal to the plain step")
        if r["graphs"] != 1 or r["sentinel_events"]:
            bad.append(f"{name}: graphs {r['graphs']}, sentinel "
                       f"{r['sentinel_events']}")
    return bad


def plan_train_phase(torch, pt):
    """The planner on the card: the dense ERNIE-base captured step through
    MeshPlan(dp=1) and through ShardingPlan at ZeRO stages 1-3 (a one-rank
    dp axis: the sharded update's shards and gathers run), each from the
    same weights, batch and step seeds as the step without a plan, bit-
    equal in the losses and every parameter; MeshPlan.auto's winner and
    report for ERNIE-base and ERNIE-large at 1 and 8 devices of 80 GB;
    predict()'s analytic step time beside the measured one (printed, no
    gate: its constants are the JAX package's, a TPU's)."""
    import warnings
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.sharding import ModelDims
    t0 = time.perf_counter()
    plain_losses, plain_params, plain_ms, _, _, _, _ = \
        _planned_run(torch, pt)
    mplan = dist.MeshPlan(dp=1)
    mesh = mplan.build_mesh()
    dist.set_mesh(mesh)
    runs = {}
    try:
        plans = {"meshplan_dp1": mplan.sharding_plan()}
        for z in (1, 2, 3):
            plans[f"zero{z}"] = dist.ShardingPlan(mesh, zero_stage=z)
        for name, sp in plans.items():
            losses, params, ms, graphs, fired, nccl, n_params = \
                _planned_run(torch, pt, mesh=mesh, sharding_plan=sp)
            runs[name] = dict(
                losses=losses, losses_bit_equal=losses == plain_losses,
                params_bit_equal=_bit_equal(params, plain_params),
                step_ms=ms, step_ms_vs_plain=ms / plain_ms, graphs=graphs,
                sentinel_events=fired, nccl_launches_per_replay=nccl,
                params=n_params)
            del params
    finally:
        dist.set_mesh(None)
    del plain_params
    torch.cuda.empty_cache()
    b, s = TRAIN_BATCH
    auto = {}
    for name, (hidden, layers, inter) in (("base", (768, 12, 3072)),
                                          ("large", (1024, 24, 4096))):
        n = ernie_param_count(BASE["vocab_size"], hidden, layers, inter,
                              BASE["max_position_embeddings"])
        dims = ModelDims(n_params=n, hidden=hidden, n_layers=layers,
                         vocab=BASE["vocab_size"], seq=s, batch=b)
        for n_dev in (1, 8):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                plan = dist.MeshPlan.auto(n_dev, dims, HBM_BYTES)
            rep = plan.predict(dims)
            auto[f"{name}_{n_dev}dev"] = dict(
                n_params=n, winner=plan.sizes,
                calibration_warning=bool(w),
                predicted_step_s=rep.predicted_step_time_s,
                predicted_hbm_bytes=rep.predicted_hbm_bytes,
                report=[dict(sizes=r.sizes, cost=r.cost,
                             hbm_per_chip=r.hbm_per_chip,
                             feasible=r.feasible,
                             analytic_step_time_s=r.analytic_step_time_s)
                        for r in plan.report])
    row = dict(card=nvidia_smi(), model="ernie_base", batch=b, seq=s,
               amp="O1 bfloat16", dropout=0.1, plain_losses=plain_losses,
               plain_step_ms=plain_ms, runs=runs, auto=auto,
               predicted_vs_measured=dict(
                   predicted_s=auto["base_1dev"]["predicted_step_s"],
                   measured_s=plain_ms / 1e3,
                   constants="the JAX package's analytic constants (a "
                             "TPU v4-class chip's spec sheet)"),
               seconds=time.perf_counter() - t0)
    emit({"plan_train": row})
    bad = plan_train_gates(row)
    if bad:
        fail("plan_train: " + "; ".join(bad))
    return row


def ernie_param_count(vocab, hidden, layers, inter, max_pos, types=2):
    """ErnieForPretraining's dense parameter count: embeddings (+ their
    norm), per layer qkv, out, two norms and the FFN, the pooler, the MLM
    transform, norm and bias, and the NSP head."""
    emb = (vocab + max_pos + types) * hidden + 2 * hidden
    layer = (hidden * 3 * hidden + 3 * hidden + hidden * hidden + hidden
             + 4 * hidden + hidden * inter + inter + inter * hidden
             + hidden)
    head = (hidden * hidden + hidden) * 2 + 2 * hidden + vocab \
        + hidden * 2 + 2
    return emb + layers * layer + head


def sp_train_gates(row):
    bad = []
    ul, ring = row["ulysses"], row["ring"]
    if not (ul["losses_bit_equal"] and ul["params_bit_equal"]):
        bad.append("the Ulysses step is not bit-equal to the dense step")
    want = {k: row["layers"] for k in KERNEL_EVENTS}
    if ul["launches_per_step"] != want or ul["warmup_launches"] != want:
        bad.append(f"Ulysses launched {ul['launches_per_step']} (warm-up "
                   f"{ul['warmup_launches']}), expected {want}")
    none = {k: 0 for k in KERNEL_EVENTS}
    if ring["launches_per_step"] != none or ring["warmup_launches"] != none:
        bad.append(f"the ring launched {ring['launches_per_step']}")
    if not (ring["loss_ok"] and ring["params_ok"]):
        bad.append(f"the ring is outside the bf16 gate: loss rel "
                   f"{ring['max_loss_rel_diff']}, params "
                   f"{ring['params_max_abs_diff']} (tol "
                   f"{ring['params_tol']})")
    for mode in ("ulysses", "ring"):
        r = row[mode]
        if r["graphs"] != 1 or r["sentinel_events"]:
            bad.append(f"{mode}: graphs {r['graphs']}, sentinel "
                       f"{r['sentinel_events']}")
    return bad


def _sp_run(torch, pt, fa, mode, mesh):
    """ERNIE-base 48x512, attention dropout 0 (hidden 0.1), captured,
    sequence_parallel=`mode` (None: dense) over `mesh`'s one-rank sp
    axis: 4 steps with STEP_SEEDS (the warm-up's launches by the
    wrappers, a replay's on the card), timed replays."""
    kw = dict(attention_probs_dropout_prob=0.0)
    if mode:
        kw["sequence_parallel"] = mode
    model = _train_model(pt, "ernie", **kw)
    step, x, y, _, layers = _train_step(
        torch, "ernie", model, **({"mesh": mesh} if mode else {}))
    _zero(fa)
    losses = []
    for sd in STEP_SEEDS:
        losses.append(float(step(x, y, seed=sd)))
        if len(losses) == 1:
            warm = dict(step.last_launches)
    params = _snapshot(step)
    prof = profile_step(torch, step, x, y)
    ms = _timed_replays(torch, step, x, y, n=PLAN_TIMED)
    out = dict(losses=losses, warmup_launches=warm,
               launches_per_step=prof["launches_per_replay"],
               nccl_launches_per_replay=prof["nccl_launches"]
               / PROFILED_REPLAYS, nccl_kernels=prof["nccl_names"],
               step_ms=ms,
               device_ms_per_step=prof["device_ms"],
               graphs=step.programs,
               sentinel_events=step.recompile_sentinel.fired)
    step.release()
    del step, model
    torch.cuda.empty_cache()
    return out, params, layers


def sp_train_phase(torch, pt, fa):
    """Sequence parallelism at an sp axis of one rank: ERNIE-base 48x512,
    attention dropout 0, dense, then sequence_parallel "ulysses" (the
    all-to-alls and the forward kernel at p 0: 12 launches of each
    kernel, bit-equal to the dense step) and "ring" (one hop of the
    blockwise carry update, torch ops: none of the kernels, and its
    losses and parameters after the steps within the bf16 gate of the
    dense step's)."""
    from paddle_tpu_torch import distributed as dist
    t0 = time.perf_counter()
    dense, dparams, layers = _sp_run(torch, pt, fa, None, None)
    mesh = dist.build_mesh({"sp": 1})
    dist.set_mesh(mesh)
    try:
        ul, uparams, _ = _sp_run(torch, pt, fa, "ulysses", mesh)
        ul["losses_bit_equal"] = ul["losses"] == dense["losses"]
        ul["params_bit_equal"] = _bit_equal(uparams, dparams)
        del uparams
        ring, rparams, _ = _sp_run(torch, pt, fa, "ring", mesh)
    finally:
        dist.set_mesh(None)
    ring["max_loss_rel_diff"] = max(
        _rel_diff(a, d) for a, d in zip(ring["losses"], dense["losses"]))
    ring["loss_ok"] = ring["max_loss_rel_diff"] <= TOL["bfloat16"]
    # the parameters as one vector against the dense run's: _err_ok's
    # bf16 gate (a tensor of its own would hold AdamW's near-zero
    # updates, which a rounding-level gradient difference can flip)
    err, tol, ok = _err_ok(torch.cat([p.float().flatten() for p in rparams]),
                           torch.cat([p.float().flatten() for p in dparams]),
                           "bfloat16")
    ring.update(params_max_abs_diff=err, params_tol=tol, params_ok=ok)
    del rparams, dparams
    torch.cuda.empty_cache()
    row = dict(card=nvidia_smi(), model="ernie_base", batch=TRAIN_BATCH[0],
               seq=TRAIN_BATCH[1], layers=layers, amp="O1 bfloat16",
               dropout=dict(hidden=0.1, attention=0.0), sp=1,
               dense=dense, ulysses=ul, ring=ring,
               seconds=time.perf_counter() - t0)
    emit({"sp_train": row})
    bad = sp_train_gates(row)
    if bad:
        fail("sp_train: " + "; ".join(bad))
    return row


# -- the host-driven pipeline (item 14b) -----------------------------------------
# ERNIE-base split by ernie_pipeline_stages into 4 stages (3+3+3+3
# blocks; the embeddings on the first, the pooler and heads on the last),
# 8 microbatches of 6x512 at TRAIN_BATCH, 1F1B; the interleaved run puts
# 2 virtual stages on each of 4 ranks (8 stages)
PIPE_STAGES, PIPE_MICRO, PIPE_V = 4, 8, 2
PIPE_CHECK_STEPS, PIPE_V_TIMED = 3, 5
# losses of the f32 dropout-0 runs against each other, relative: the
# same function, reduced in another order (8 microbatch means of
# gradients and losses against one batch's; the unsplit model's and
# the split stages' backward sum a residual's two gradients in another
# order)
PIPE_F32_RTOL = 1e-5


def pipe_expected(S, M, L=BASE["num_hidden_layers"]):
    """What a step of the engine must show: its dispatches (S·M F,
    (S-1)·M B, S updates), its graphs (per stage F, B0 and B, the last
    stage's L0 and L, and an update each; B and L only when M > 1), each
    stage's peak of held inputs under 1F1B (min(M, S - s)), and the
    kernel launches a step of L blocks split over the stages (the
    forward in F and again in every non-last stage's B)."""
    base, extra = divmod(L, S)
    counts = [base + (1 if i < extra else 0) for i in range(S)]
    remat = sum(counts[:-1])
    per_op = 1 if M == 1 else 2
    return dict(dispatches=S * M + (S - 1) * M + S,
                graphs=(S - 1) * (1 + per_op) + per_op + S,
                in_flight=[min(M, S - s) for s in range(S)],
                launches={"flash_attn_fwd": M * (L + remat),
                          "flash_attn_bwd_dq": M * L,
                          "flash_attn_bwd_dkv": M * L})


def stage_state(plain_sd, S):
    """ErnieForPretraining's state_dict cut into ernie_pipeline_stages'
    S stage state_dicts: the embeddings to the first stage, the blocks
    in turn, the pooler, MLM transform and norm and NSP head to the last,
    whose untied decoder takes the word embeddings transposed and the
    MLM bias (the tied model's function at these weights)."""
    L = len({k.split(".")[2] for k in plain_sd
             if k.startswith("ernie.encoder.")})
    base, extra = divmod(L, S)
    counts = [base + (1 if i < extra else 0) for i in range(S)]
    out = [{} for _ in range(S)]
    owner, start = {}, 0
    for s, n in enumerate(counts):
        for j in range(n):
            owner[start + j] = (s, j)
        start += n
    for k, v in plain_sd.items():
        if k.startswith("ernie.embeddings."):
            out[0][k[len("ernie."):]] = v
        elif k.startswith("ernie.encoder."):
            i, rest = k[len("ernie.encoder."):].split(".", 1)
            s, j = owner[int(i)]
            out[s][f"blocks.{j}.{rest}"] = v
        elif k.startswith("ernie.pooler."):
            out[-1][k[len("ernie."):]] = v
        elif k == "mlm_bias":
            out[-1]["decoder.bias"] = v
        else:
            out[-1][k] = v
    out[-1]["decoder.weight"] = \
        plain_sd["ernie.embeddings.word_embeddings.weight"].t()
    return out


def _untied_plain(pt, cfg, plain_sd, device="cuda"):
    """ErnieForPretraining (config cfg) in train mode with its decoder
    untied: a Linear of its own in place of the word embeddings and
    mlm_bias, holding them as stage_state gives them to the last stage.
    The pipeline's function in the unsplit model, so every update of
    the pipeline has its counterpart here."""
    from paddle_tpu_torch.models import ErnieForPretraining
    F = pt.nn.functional

    class UntiedErnie(ErnieForPretraining):
        def __init__(self, cfg):
            super().__init__(cfg, device=device)
            del self.mlm_bias
            self.decoder = pt.nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                        device=device)

        def forward(self, input_ids):
            seq, pooled = self.ernie(input_ids)
            h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
            b, s = h.shape[0], h.shape[1]
            logits = self.decoder(h.reshape(-1, h.shape[-1]))
            return logits.reshape(b, s, -1), self.nsp(pooled)

    model = UntiedErnie(cfg)
    sd = {k: v for k, v in plain_sd.items() if k != "mlm_bias"}
    sd["decoder.weight"] = \
        plain_sd["ernie.embeddings.word_embeddings.weight"].t()
    sd["decoder.bias"] = plain_sd["mlm_bias"]
    missing, extra = model.set_state_dict(sd)
    if missing or extra:
        fail(f"the untied ERNIE's weights: missing {missing}, extra {extra}")
    return model.train()


def _pipe_stages(torch, pt, plain_sd, S, **kw):
    """ERNIE-base's S stages on the card in train mode, holding the
    plain model's weights (stage_state); kw goes to the config."""
    from paddle_tpu_torch.models import ErnieConfig, ernie_pipeline_stages
    stages = ernie_pipeline_stages(ErnieConfig.base(**BASE, **kw), S,
                                   device="cuda")
    for st, sd in zip(stages, stage_state(plain_sd, S)):
        st.set_state_dict(sd)
        st.train()
    return stages


def _pipe_engine(torch, pt, plain_sd, S, eager=False, v=1, **kw):
    from paddle_tpu_torch.distributed import PipelineParallel
    from paddle_tpu_torch.optimizer import AdamW
    stages = _pipe_stages(torch, pt, plain_sd, S, **kw)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    return PipelineParallel(stages, _ernie_loss, opt, num_micro=PIPE_MICRO,
                            schedule="interleaved" if v > 1 else "1f1b",
                            virtual_pipeline_degree=v, device="cuda",
                            eager=eager)


def _pipe_params(pp):
    return [p.detach().clone() for st in pp.stages for p in st.params]


def _pipe_steps(pt, pp, x, y, seeds, amp_on):
    """One train_batch a seed (under O1 bf16 auto_cast when amp_on);
    returns the losses as floats."""
    import contextlib
    from paddle_tpu_torch import amp
    ctx = (lambda: amp.auto_cast(level="O1", dtype="bfloat16")) if amp_on \
        else contextlib.nullcontext
    out = []
    for sd in seeds:
        with ctx():
            out.append(float(pp.train_batch(x, y, seed=sd)))
    return out


def profile_pipeline(torch, fn):
    """device_profile over PROFILED_REPLAYS captured pipeline steps in
    PROFILE_ROUNDS rounds: the flash kernels a step, counted on the card
    (max_counts), and the forward's launches by route; the profile is
    the round with the most device events. Fails if the profiler saw no
    device time."""
    rounds = [device_profile(torch, fn, PROFILED_REPLAYS)
              for _ in range(PROFILE_ROUNDS)]
    prof = max(rounds, key=lambda r: r["device_events"])
    if prof["device_ms"] <= 0:
        fail("torch.profiler saw no device time inside a captured "
             "pipeline step")
    prof["kernel_launches"] = max_counts([r["kernel_launches"]
                                          for r in rounds])
    prof["routes"] = {k: max(r["routes"][k] for r in rounds)
                      for k in rounds[0]["routes"]}
    prof["device_events_by_round"] = [r["device_events"] for r in rounds]
    prof["launches_per_step"] = per_call(prof["kernel_launches"],
                                         PROFILED_REPLAYS)
    prof["routes_per_step"] = per_call(prof["routes"], PROFILED_REPLAYS)
    return prof


def _kernels_at(row, shape):
    """The three kernels' numbers in the `kernels` line from one
    bwd_kernel_case row, at its shape (named by `shape`)."""
    out = {
        "flash_attn_fwd": dict(
            max_abs_err=row["o_max_abs_err"], worst_row=row["o_worst_row"],
            ms=row["fwd_ms"], plain_ms=row["fwd_plain_ms"],
            bound_ms=row["fwd_bound_ms"], bound_by=row["fwd_bound_by"],
            library_ms=row["fwd_library_ms"],
            dropout_work={k: row["fwd_bound"].get(k) for k in (
                "philox_calls", "philox_int_instructions",
                "philox_floor_ms", "bound_reachable")}),
        "flash_attn_bwd_dq": dict(
            max_abs_err=row["dq_max_abs_err"], worst_row=row["dq_worst_row"],
            ms=row["dq_ms"], plain_ms=row["dq_plain_ms"],
            bound_ms=row["dq_bound_ms"], bound_by=row["dq_bound_by"],
            library_ms=None),
        "flash_attn_bwd_dkv": dict(
            max_abs_err=max(row["dk_max_abs_err"], row["dv_max_abs_err"]),
            worst_row=max(row["dk_worst_row"], row["dv_worst_row"]),
            ms=row["dkv_ms"], plain_ms=row["dkv_plain_ms"],
            bound_ms=row["dkv_bound_ms"], bound_by=row["dkv_bound_by"],
            library_ms=None)}
    for v in out.values():
        v.update(shape=shape, backward_ms=row["backward_ms"],
                 backward_library_ms=row["backward_library_ms"])
    return out


def pipe_kernel_phase(torch, fa, philox):
    """The three kernels at the pipeline's microbatch shape (b 48/8 = 6,
    s 512, n 12, h 64, bf16 under O1, non-causal, p 0.1, strided qkv
    views) against their plain versions, with their times, bounds and
    SDPA's at the same p (bwd_kernel_case); then the mask probe there."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    b, s = TRAIN_BATCH[0] // PIPE_MICRO, TRAIN_BATCH[1]
    n = BASE["num_attention_heads"]
    h = BASE["hidden_size"] // n
    row = bwd_kernel_case(torch, fa, gen,
                          (b, s, n, h, False, "bfloat16", DROP_P), philox,
                          tag="pipe_kernel")
    probe = mask_probe_case(torch, fa, b, n, h, s, "bfloat16", causal=False)
    return row, probe


def pipeline_train_gates(row):
    """What pipeline_train must show; a list of the failures (empty: ok)."""
    bad = []
    want = row["expected"]
    cap = row["captured_vs_eager"]
    if not (cap["losses_bit_equal"] and cap["params_bit_equal"]):
        bad.append("the captured engine is not bit-equal to the eager one")
    if row["launches_per_step"] != want["launches"] \
            or row["eager_launches_per_step"] != want["launches"]:
        bad.append(f"a step launched {row['launches_per_step']} (eager "
                   f"{row['eager_launches_per_step']}), expected "
                   f"{want['launches']}")
    fwd = want["launches"]["flash_attn_fwd"]
    if row["routes_per_step"].get("fwd_wgmma") != fwd:
        bad.append(f"forward routes {row['routes_per_step']}: the "
                   f"recompute left bf16 (expected {fwd} fwd_wgmma)")
    if not all(row["path_launches"].values()):
        bad.append(f"the pipeline path launched no kernel of "
                   f"{row['path_launches']}")
    if row["dispatches"] != want["dispatches"]:
        bad.append(f"dispatches {row['dispatches']}, expected "
                   f"{want['dispatches']}")
    if row["graphs"] != want["graphs"] or row["captures"] != row["graphs"] \
            or row["sentinel_events"]:
        bad.append(f"graphs {row['graphs']} (captures {row['captures']}, "
                   f"expected {want['graphs']}), sentinel "
                   f"{row['sentinel_events']}")
    if row["in_flight"] != want["in_flight"]:
        bad.append(f"in-flight inputs {row['in_flight']}, bound "
                   f"{want['in_flight']}")
    par = row["plain_parity"]
    if not par["ok"]:
        bad.append(f"the f32 dropout-0 engine is outside {PIPE_F32_RTOL} "
                   f"of the plain step: {par}")
    if not row["interleaved"]["losses_ok"]:
        bad.append(f"the interleaved losses differ from 1F1B's: "
                   f"{row['interleaved']}")
    if not all(math.isfinite(v) for v in row["losses"]) \
            or not 0 < row["mfu"] < 1:
        bad.append(f"losses {row['losses']}, MFU {row['mfu']}")
    return bad


def _rel_all(a, b):
    return max(_rel_diff(x, y) for x, y in zip(a, b))


def _pipe_f32_runs(torch, pt, plain_sd, x, y):
    """At dropout 0 and f32: the plain captured TrainStep of
    ErnieForPretraining with its decoder untied (_untied_plain, from the
    same weights: the pipeline's function), the captured 1F1B engine and
    the interleaved one (PIPE_V virtual stages on each of 4 ranks):
    losses over PIPE_CHECK_STEPS steps, then timed steps of both
    engines."""
    from paddle_tpu_torch.models import ErnieConfig
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    seeds = STEP_SEEDS[:PIPE_CHECK_STEPS]
    kw = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    plain = _untied_plain(pt, ErnieConfig.base(**BASE, **kw), plain_sd)
    step = TrainStep(plain, _ernie_loss, AdamW(
        learning_rate=1e-4, parameters=plain.parameters(), weight_decay=0.01))
    plain_losses = [float(step(x, y, seed=sd)) for sd in seeds]
    step.release()
    del step, plain
    torch.cuda.empty_cache()
    runs = {}
    for name, S, v in (("1f1b", PIPE_STAGES, 1),
                       ("interleaved", PIPE_STAGES * PIPE_V, PIPE_V)):
        pp = _pipe_engine(torch, pt, plain_sd, S, v=v, **kw)
        losses = _pipe_steps(pt, pp, x, y, seeds, False)
        _pipe_steps(pt, pp, x, y, [None] * 2, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _pipe_steps(pt, pp, x, y, [None] * PIPE_V_TIMED, False)
        torch.cuda.synchronize()
        runs[name] = dict(stages=S, virtual_pipeline_degree=v,
                          losses=losses, graphs=pp.programs,
                          step_ms=(time.perf_counter() - t0)
                          / PIPE_V_TIMED * 1e3,
                          bubble_fraction=pp.schedule_bubble_fraction,
                          dispatches=pp.last_dispatch_count)
        pp.release()
        del pp
        torch.cuda.empty_cache()
    eng = runs["1f1b"]["losses"]
    parity = dict(precision="float32, TF32 off", dropout=0.0,
                  plain="ErnieForPretraining, decoder untied",
                  rtol=PIPE_F32_RTOL, plain_losses=plain_losses,
                  engine_losses=eng, max_rel=_rel_all(eng, plain_losses))
    parity["ok"] = parity["max_rel"] <= PIPE_F32_RTOL
    inter = dict(runs["interleaved"],
                 max_rel_vs_1f1b=_rel_all(runs["interleaved"]["losses"], eng),
                 f32_1f1b_step_ms=runs["1f1b"]["step_ms"])
    inter["losses_ok"] = inter["max_rel_vs_1f1b"] <= PIPE_F32_RTOL
    return parity, inter


def pipeline_train_phase(torch, pt, fa, dense):
    """ERNIE-base pretraining through PipelineParallel: 4 stages x 8
    microbatches, 1F1B, AdamW(1e-4, wd 0.01), O1 bf16 under
    amp.auto_cast, dropout 0.1, from the weights of _train_model's
    ErnieForPretraining (SEED), at TRAIN_BATCH. The captured engine (one
    CUDA graph per stage, op kind and signature) against the eager one
    over PIPE_CHECK_STEPS seeded steps: losses and every parameter
    bit-equal. Then 2 warm-up and 10 timed steps of the captured engine,
    two steps under torch.profiler (the kernels a step and the forward's
    route); the path's launches are the wrappers' counts over the
    captured engine's calls (zeroed just before its first step and again
    after the eager reference, which is left out) plus the profiled
    steps' counts on the card. Then the dispatches, graphs, sentinel,
    each stage's peak of held inputs against min(M, S - s), the bubble
    fraction, step ms, device ms, the
    idle share, tokens/s, MFU (PERF.md §2's formula over
    ErnieForPretraining's parameters: the recompute is not counted),
    peak memory over the first step and over the timed ones beside the
    plain captured step's (`dense`: captured_train's ERNIE row of this
    run, the same weights and batch). Last, _pipe_f32_runs."""
    t0 = time.perf_counter()
    S, M = PIPE_STAGES, PIPE_MICRO
    want = pipe_expected(S, M)
    plain = _train_model(pt, "ernie")
    plain_sd = {k: v.detach().clone() for k, v in plain.state_dict().items()}
    n_params = sum(p.numel() for p in plain.parameters())
    cfg = plain.config
    del plain
    x, y = _train_batch(torch, cfg.vocab_size, *TRAIN_BATCH, "cuda")
    seeds = STEP_SEEDS[:PIPE_CHECK_STEPS]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pp = _pipe_engine(torch, pt, plain_sd, S)
    _zero(fa)
    graph_losses = _pipe_steps(pt, pp, x, y, seeds[:1], True)
    first_peak = torch.cuda.max_memory_allocated()
    graph_losses += _pipe_steps(pt, pp, x, y, seeds[1:], True)
    # the captured engine's own launches (its programs' eager first runs
    # and captures; a replay does not pass through the wrappers), read
    # before the eager reference runs
    wrapper = dict(fa.launches)
    graph_params = _pipe_params(pp)
    ref = _pipe_engine(torch, pt, plain_sd, S, eager=True)
    before = dict(fa.launches)
    eager_losses = _pipe_steps(pt, ref, x, y, seeds[:1], True)
    eager_launches = {k: v - before[k] for k, v in fa.launches.items()}
    eager_losses += _pipe_steps(pt, ref, x, y, seeds[1:], True)
    cap = dict(step_seeds=seeds, graph_losses=graph_losses,
               eager_losses=eager_losses,
               losses_bit_equal=graph_losses == eager_losses,
               params_bit_equal=_bit_equal(graph_params, _pipe_params(ref)),
               params_max_abs_diff=_max_abs_diff(graph_params,
                                                 _pipe_params(ref)))
    eager_ms = time_ms(lambda: _pipe_steps(pt, ref, x, y, [None], True),
                       reps=3, warmup=1)
    del ref, graph_params
    torch.cuda.empty_cache()
    _zero(fa)
    losses = _pipe_steps(pt, pp, x, y, [None] * TRAIN_WARMUP, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    losses += _pipe_steps(pt, pp, x, y, [None] * TRAIN_STEPS, True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    steady_peak = torch.cuda.max_memory_allocated()
    wrapper = _sum_launches([wrapper, dict(fa.launches)])
    prof = profile_pipeline(
        torch, lambda: _pipe_steps(pt, pp, x, y, [None], True))
    b, s = TRAIN_BATCH
    step_ms = secs / TRAIN_STEPS * 1e3
    row = dict(card=nvidia_smi(), model="ernie_base", batch=b, seq=s,
               micro_batch=b // M, stages=S, num_micro=M, schedule="1f1b",
               amp="O1 bfloat16", dropout=0.1, layers=cfg.num_hidden_layers,
               expected=want, captured_vs_eager=cap,
               launches_per_step=prof["launches_per_step"],
               routes_per_step=prof["routes_per_step"],
               eager_launches_per_step=eager_launches,
               path_launches=_sum_launches([wrapper,
                                            prof["kernel_launches"]]),
               wrapper_counts=wrapper,
               dispatches=pp.last_dispatch_count, graphs=pp.programs,
               captures=pp.captures, replays=pp.replays,
               sentinel_events=pp.recompile_sentinel.fired,
               in_flight=pp.last_in_flight,
               bubble_fraction=pp.schedule_bubble_fraction,
               tick_ms_p50=sorted(pp.last_tick_ms)[len(pp.last_tick_ms) // 2],
               losses=graph_losses + losses, warmup_steps=TRAIN_WARMUP,
               timed_steps=TRAIN_STEPS, step_ms=step_ms,
               eager_step_ms=eager_ms,
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               tokens_per_s=b * s * TRAIN_STEPS / secs, params=n_params,
               peak_first_step_bytes=first_peak,
               peak_first_step_above_base_bytes=first_peak - base,
               peak_steady_bytes=steady_peak,
               profile=_profile_row(prof, top=10))
    _with_mfu(row, cfg.num_hidden_layers, cfg.hidden_size)
    pp.release()
    del pp
    torch.cuda.empty_cache()
    row["plain_parity"], row["interleaved"] = _pipe_f32_runs(
        torch, pt, plain_sd, x, y)
    row["plain"] = dict(source="captured_train's ERNIE row of this run "
                               "(the same weights from SEED and batch)",
                        step_ms=dense["step_ms"],
                        device_ms_per_step=dense["device_ms_per_step"],
                        tokens_per_s=dense["tokens_per_s"], mfu=dense["mfu"],
                        peak_memory_bytes=dense["peak_memory_bytes"],
                        peak_above_base_bytes=dense["peak_above_base_bytes"])
    row["pipeline_over_plain_step"] = step_ms / dense["step_ms"]
    row["seconds"] = time.perf_counter() - t0
    emit({"pipeline_train": row})
    bad = pipeline_train_gates(row)
    if bad:
        fail("pipeline_train: " + "; ".join(bad))
    return row


# -- the vision path: ResNet-50 through the captured TrainStep ---------------

RESNET = dict(depth=50, num_classes=1000)  # bench.py:194's resnet50
RESNET_BATCH, RESNET_SIZE, RESNET_LABELS = 64, 224, 10
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
RESNET_CHECK_STEPS = 3
RESNET_WARMUP, RESNET_STEPS = 2, 12
RESNET_CPU = dict(depth=18, num_classes=10, batch=4, size=32)
RESNET_CPU_RTOL = 1e-3
# the multiply-adds per 224x224 image usually cited for ResNet-50 (4.1 G),
# and how far the count from the model's shapes may sit from it
RESNET50_CITED_MACS, RESNET_MACS_SLACK = 4.1e9, 0.05


def layer_macs(torch, model, shape, device):
    """{layer name: multiply-adds per sample} of every convolution and
    linear layer of `model`, from the output shapes of one eval forward
    of a `shape` input under no_grad (hooks read the shapes): a
    convolution's output elements x in_channels/groups x kernel size,
    a linear layer's in x out features."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.layer.conv import _ConvNd
    macs, hooks = {}, []

    def hook(name):
        def fn(mod, inputs, out):
            per = out.numel() // out.shape[0]
            if isinstance(mod, _ConvNd):
                k = math.prod(mod.kernel_size)
                cin = mod.in_channels // mod.groups
                if mod.transpose:
                    per = inputs[0].numel() // inputs[0].shape[0]
                    cin = mod.out_channels // mod.groups
                macs[name] = per * cin * k
            else:
                macs[name] = mod.in_features * mod.out_features
        return fn

    for name, mod in model.named_modules():
        if isinstance(mod, (_ConvNd, Linear)):
            hooks.append(mod.register_forward_hook(hook(name)))
    mode = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(shape, device=device))
    finally:
        model.train(mode)
        for h in hooks:
            h.remove()
    return macs


def train_flops(macs_per_sample, batch):
    """A training step's FLOPs: 2 per multiply-add, 3 passes (the forward
    and the backward's two products, input and weight gradients)."""
    return 3 * 2 * macs_per_sample * batch


def resnet_train_gates(row):
    """The resnet_train phase's failures, each a message (empty: ok)."""
    bad = []
    cap = row["captured_vs_eager"]
    if not (cap["losses_bit_equal"] and cap["params_bit_equal"]
            and cap["buffers_bit_equal"]):
        bad.append(f"the replay is not bit-equal to the eager step: {cap}")
    if row["graphs"] != 1 or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events for one signature")
    cpu = row["card_vs_cpu"]
    if not cpu["max_rel"] <= RESNET_CPU_RTOL:
        bad.append(f"card and CPU differ: {cpu}")
    if not all(math.isfinite(v) for v in row["losses"]):
        bad.append(f"non-finite losses {row['losses']}")
    if abs(row["macs_per_image"] / RESNET50_CITED_MACS - 1) > \
            RESNET_MACS_SLACK:
        bad.append(f"{row['macs_per_image']} multiply-adds an image, not "
                   f"near {RESNET50_CITED_MACS}")
    if not 0 < row["mfu"] < 1:
        bad.append(f"MFU {row['mfu']} outside (0, 1)")
    ev = row["eval"]
    if not (ev["finite"] and ev["shape"] == [RESNET_BATCH,
                                             RESNET["num_classes"]]):
        bad.append(f"the eval forward: {ev}")
    if row["flash_launches"] and any(row["flash_launches"].values()):
        bad.append(f"the vision path launched attention kernels: "
                   f"{row['flash_launches']}")
    return bad


def _resnet(pt, device, depth, num_classes):
    from paddle_tpu_torch.vision.models import resnet18, resnet50
    pt.seed(SEED)
    ctor = {18: resnet18, 50: resnet50}[depth]
    return ctor(num_classes=num_classes, device=device).train()


def _resnet_step(pt, model, amp=True):
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.static import TrainStep
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.parameters(), weight_decay=RESNET_WD)
    kw = dict(amp_level="O1", amp_dtype="bfloat16") if amp else {}
    return TrainStep(model, lambda out, y: cross_entropy(out, y), opt, **kw)


def _resnet_batch(torch, batch, size, device):
    import numpy as np
    rng = np.random.RandomState(SEED)
    x = rng.randn(batch, 3, size, size).astype(np.float32)
    y = rng.randint(0, RESNET_LABELS, (batch,)).astype(np.int64)
    return (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def _running_stats(model):
    return [t.detach().clone() for k, t in model.state_dict().items()
            if k.endswith(("_mean", "_variance"))]


def _resnet_replays(torch, step, x, y, warmup, steps):
    """(seconds of `steps` replays after `warmup`, the last loss)."""
    for _ in range(warmup):
        step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(x, y)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, float(loss)


def _max_rel(a, b):
    """The largest |a - b| over max(1, max|b|) of each pair of tensors
    (compared on the host: one side may be on the card)."""
    return max(float((x.float().cpu() - y.float().cpu()).abs().max()
                     / max(1.0, float(y.float().abs().max())))
               for x, y in zip(a, b))


def resnet_cpu_check(torch, pt):
    """resnet18(num_classes=10) at 4x3x32x32, f32, from the same weights:
    3 TrainStep steps on the card (captured) and on the CPU (eager),
    each card step started from the CPU step's state before it
    (state_dict: weights, running statistics, velocities): every loss,
    parameter and running statistic within RESNET_CPU_RTOL (relative to
    max(1, max|cpu|)). Not left to run free: at lr 0.1 this model's loss
    grows (3.2, 7.3, 8.4), and the free run carries each step's
    summation-order differences into the next, 1.7% apart in the third
    loss (call 14a); the free card losses are printed beside."""
    c = RESNET_CPU
    cpu = _resnet(pt, "cpu", c["depth"], c["num_classes"])
    card = _resnet(pt, "cuda", c["depth"], c["num_classes"])
    card.set_state_dict({k: v.detach() for k, v in cpu.state_dict().items()})
    s_cpu = _resnet_step(pt, cpu, amp=False)
    s_card = _resnet_step(pt, card, amp=False)
    xc, yc = _resnet_batch(torch, c["batch"], c["size"], "cpu")
    xg, yg = _resnet_batch(torch, c["batch"], c["size"], "cuda")
    free = [float(s_card(xg, yg)) for _ in range(RESNET_CHECK_STEPS)]
    losses, params, stats = [], [], []
    for _ in range(RESNET_CHECK_STEPS):
        s_card.set_state_dict(s_cpu.state_dict())
        lg, lc = float(s_card(xg, yg)), float(s_cpu(xc, yc))
        losses.append(_rel_diff(lg, lc))
        params.append(_max_rel(_snapshot(s_card), _snapshot(s_cpu)))
        stats.append(_max_rel(_running_stats(card), _running_stats(cpu)))
    graphs = s_card.programs
    s_card.release()
    return dict(model=f"resnet{c['depth']}", batch=c["batch"],
                size=c["size"], dtype="float32", steps=RESNET_CHECK_STEPS,
                started_from="the CPU step's state, each step",
                loss_rel_diff=losses, params_max_rel=params,
                running_stats_max_rel=stats, card_graphs=graphs,
                max_rel=max(losses + params + stats),
                free_card_losses=free, rtol=RESNET_CPU_RTOL)


def resnet_train_phase(torch, pt, fa):
    """ResNet-50 (bench.py's bench_resnet: resnet50(num_classes=1000),
    batch 64 of 3x224x224 and labels in [0, 10) from numpy seed 0,
    Momentum(0.1, momentum 0.9, weight_decay 1e-4), TrainStep O1 bf16)
    through the captured TrainStep. From one start state (state_dict,
    BatchNorm's running statistics in it), the first call and 2 replays
    against 3 eager steps: losses, every parameter and every running
    statistic bit-equal. Then RESNET_WARMUP + RESNET_STEPS replays on a
    synchronised host clock: images/s, step ms, the device ms and
    kernels of a replay (profile_step), the idle share, MFU (train_flops
    over the multiply-adds counted from the model's shapes, against the
    bf16 dense peak), peak memory over the first call, graphs, sentinel
    events. The same replays once with conv.DETERMINISTIC off (a second
    capture), to price the deterministic convolutions. The eval forward
    (build_eval_fn, captured) at the batch, with the trained running
    statistics: ms a batch. Last, resnet_cpu_check."""
    from paddle_tpu_torch.nn.functional import conv as _conv
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = _resnet(pt, "cuda", RESNET["depth"], RESNET["num_classes"])
    shape = (1, 3, RESNET_SIZE, RESNET_SIZE)
    macs = layer_macs(torch, model, shape, "cuda")
    per_image = sum(macs.values())
    step = _resnet_step(pt, model)
    x, y = _resnet_batch(torch, RESNET_BATCH, RESNET_SIZE, "cuda")
    s0 = _to_cpu(step.state_dict())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa)
    graph_losses = [float(step(x, y))]
    peak = torch.cuda.max_memory_allocated()
    graph_losses += [float(step(x, y))
                     for _ in range(RESNET_CHECK_STEPS - 1)]
    flash = dict(fa.launches)
    graph_params, graph_stats = _snapshot(step), _running_stats(model)
    step.set_state_dict(s0)
    eager_losses = [float(step.eager_step(x, y))
                    for _ in range(RESNET_CHECK_STEPS)]
    eager_params, eager_stats = _snapshot(step), _running_stats(model)
    cap = dict(steps=RESNET_CHECK_STEPS, graph_losses=graph_losses,
               eager_losses=eager_losses,
               losses_bit_equal=graph_losses == eager_losses,
               params_bit_equal=_bit_equal(graph_params, eager_params),
               params_max_abs_diff=_max_abs_diff(graph_params, eager_params),
               buffers_bit_equal=_bit_equal(graph_stats, eager_stats),
               buffers_max_abs_diff=_max_abs_diff(graph_stats, eager_stats),
               running_stats=len(graph_stats))
    del graph_params, eager_params, graph_stats, eager_stats
    eager_ms = time_ms(lambda: step.eager_step(x, y), reps=3, warmup=1)
    secs, last = _resnet_replays(torch, step, x, y, RESNET_WARMUP,
                                RESNET_STEPS)
    prof = profile_step(torch, step, x, y)
    step_ms = secs / RESNET_STEPS * 1e3
    flops = train_flops(per_image, RESNET_BATCH)
    ev = step.build_eval_fn()
    logits = ev(x)
    eval_ms = time_ms(lambda: ev(x), reps=10, warmup=2)
    row = dict(card=nvidia_smi(), model="resnet50", batch=RESNET_BATCH,
               image=[3, RESNET_SIZE, RESNET_SIZE], amp="O1 bfloat16",
               optimizer=f"Momentum({RESNET_LR}, momentum "
                         f"{RESNET_MOMENTUM}, weight_decay {RESNET_WD})",
               params=sum(p.numel() for p in step.params),
               running_stats=sum(t.numel() for k, t in
                                 model.state_dict().items()
                                 if k.endswith(("_mean", "_variance"))),
               captured_vs_eager=cap, graphs=step.programs,
               captures=step.captures, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               flash_launches=flash,
               losses=graph_losses + [last], warmup_steps=RESNET_WARMUP,
               timed_steps=RESNET_STEPS, step_ms=step_ms,
               images_per_s=RESNET_BATCH * RESNET_STEPS / secs,
               eager_step_ms=eager_ms,
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               kernel_launches_per_replay=prof["events"],
               macs_per_image=per_image,
               convolutions=sum(1 for k in macs if "fc" not in k),
               flops_per_step=flops,
               mfu=flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
               mfu_device=flops / (prof["device_ms"] / 1e3)
               / PEAK_FLOPS["bfloat16"],
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base,
               profile=_profile_row(prof, top=12),
               eval=dict(ms_per_batch=eval_ms, programs=ev.programs,
                         shape=list(logits.shape),
                         finite=bool(torch.isfinite(logits).all())))
    step.release()
    del step, ev, logits
    torch.cuda.empty_cache()
    # the deterministic convolutions' price: a second capture without them
    _conv.DETERMINISTIC = False
    try:
        free = _resnet_step(pt, model)
        free(x, y)
        secs_free, _ = _resnet_replays(torch, free, x, y, RESNET_WARMUP,
                                      RESNET_STEPS)
        free.release()
    finally:
        _conv.DETERMINISTIC = True
    row["nondeterministic_conv"] = dict(
        step_ms=secs_free / RESNET_STEPS * 1e3,
        images_per_s=RESNET_BATCH * RESNET_STEPS / secs_free)
    del model, free
    torch.cuda.empty_cache()
    row["card_vs_cpu"] = resnet_cpu_check(torch, pt)
    row["seconds"] = time.perf_counter() - t0
    emit({"resnet_train": row})
    bad = resnet_train_gates(row)
    if bad:
        fail("resnet_train: " + "; ".join(bad))
    return row


# -- YOLOv3, BASELINE config 4: the NMS kernel, training, fit, serving ---------

# YOLOv3() at its defaults (models/yolo.py): 80 classes, width 16, the
# COCO anchors, ignore_thresh 0.7
YOLO_CLASSES = 80
YOLO_BATCH = 8
# the ends of PaddleDetection's YOLOv3 multi-scale list (320, 352, ...,
# 608): the two size buckets
YOLO_SIZES = (608, 320)
YOLO_SCALES = tuple(range(320, 609, 32))
# gt slots an image (PaddleDetection's num_max_boxes), valid boxes 1..20
YOLO_SLOTS, YOLO_MAX_VALID = 50, 20
YOLO_LR = 1e-3
YOLO_CHECK_STEPS, YOLO_ALTERNATE = 3, 6
YOLO_WARMUP, YOLO_STEPS = 2, 12
YOLO_CPU = dict(width=4, num_classes=4, batch=2, size=64)
YOLO_CPU_RTOL = 1e-3
YOLO_FIT_IMAGES = 64
# predict's defaults (models/yolo.py) and multiclass_nms's nms_top_k
YOLO_SERVE = dict(batch=8, size=608, conf_thresh=0.05, nms_threshold=0.45,
                  keep_top_k=100, nms_top_k=400)
# the greedy NMS kernel's cases: 8 images x 80 classes of K candidates;
# (iou_threshold, eta): predict's 0.45 without decay, and adaptive NMS,
# whose eta decays the threshold only while it is above 0.5
NMS_PROBLEMS, NMS_KS = 640, (400, 1000)
NMS_THRESHOLDS = ((0.45, 1.0), (0.7, 0.9))
# float operations of one IoU test in csrc/nms.cu: 2 max and 2 min (the
# intersection's corners), 2 subtractions, 2 additions (the +1 offset),
# 2 clamps at 0, the product, the union's addition and subtraction, the
# division and the compare; each box's area is made once
NMS_IOU_OPS = 15


def yolo_synth_batch(np, rng, n, size, classes=YOLO_CLASSES,
                     slots=YOLO_SLOTS, max_valid=YOLO_MAX_VALID):
    """examples/train_yolo.py's synth_batch with `slots` gt slots and up
    to `max_valid` valid boxes: images N(0, 0.1^2); per image 1 to
    max_valid boxes, w and h uniform in [0.1, 0.5], the centre inside
    the image, labels in [0, classes); padding rows all zero."""
    imgs = rng.randn(n, 3, size, size).astype(np.float32) * 0.1
    gt_box = np.zeros((n, slots, 4), np.float32)
    gt_label = np.zeros((n, slots), np.int32)
    for i in range(n):
        k = rng.randint(1, max_valid + 1)
        for j in range(k):
            w, h = rng.uniform(0.1, 0.5, 2)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            gt_box[i, j] = [cx, cy, w, h]
            gt_label[i, j] = rng.randint(0, classes)
    return imgs, gt_box, gt_label


def _yolo_on(torch, arrays, device):
    imgs, box, lbl = arrays
    return (torch.from_numpy(imgs).to(device),
            (torch.from_numpy(box).to(device),
             torch.from_numpy(lbl).to(device)))


def _yolo(pt, device, **kw):
    from paddle_tpu_torch.models import YOLOv3
    pt.seed(SEED)
    return YOLOv3(device=device, **kw).train()


def _yolo_step(pt, model, amp=True):
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    opt = Adam(learning_rate=YOLO_LR, parameters=model.parameters())
    kw = dict(amp_level="O1", amp_dtype="bfloat16") if amp else {}
    return TrainStep(model, lambda out, box, lbl: model.loss(out, box, lbl),
                     opt, **kw)


def nms_candidates(np, rng, p, k, normalized, invalid_frac=0.3):
    """p problems of k candidates sorted by score (descending, scores
    rounded to 1e-3 so ties are common), the last invalid_frac at -inf;
    xyxy boxes with centres over the canvas (1 x 1, or YOLO_SERVE's
    608 x 608 pixels) and sides of 2-32% of it."""
    scale = 1.0 if normalized else float(YOLO_SERVE["size"])
    c = rng.rand(p, k, 2) * scale
    side = (rng.rand(p, k, 2) * 0.3 + 0.02) * scale
    boxes = np.concatenate([c - side / 2, c + side / 2], -1)
    scores = -np.sort(-np.round(rng.rand(p, k), 3), axis=-1)
    scores[:, k - int(k * invalid_frac):] = -np.inf
    return boxes.astype(np.float32), scores.astype(np.float32)


def nms_bound(valid, k):
    """(bound ms, "bytes" or "operations", IoU tests, bytes) of greedy
    NMS over problems with `valid` valid candidates each (a list): the
    IoUs the valid candidates need (V (V - 1) / 2 a problem, NMS_IOU_OPS
    each) over the FP32 peak, against the boxes and scores read and the
    keep mask written once, over HBM's rate."""
    pairs = sum(v * (v - 1) // 2 for v in valid)
    nbytes = len(valid) * k * (16 + 4 + 1)
    ops_ms = pairs * NMS_IOU_OPS / PEAK_FLOPS["float32"] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, pairs, nbytes


def _nms_case(torch, nms, boxes, scores, normalized, thr, eta):
    """The kernel against the plain version on one set of candidates."""
    got = nms.greedy_nms_mask(boxes, scores, thr, normalized, eta)
    want = nms.greedy_nms_mask_plain(boxes, scores, thr, normalized, eta)
    torch.cuda.synchronize()
    valid = (scores > float("-inf")).sum(-1).tolist()
    k = scores.shape[-1]
    bound, by, pairs, nbytes = nms_bound(valid, k)
    ms = time_ms(lambda: nms.greedy_nms_mask(boxes, scores, thr,
                                             normalized, eta), reps=20)
    plain_ms = time_ms(lambda: nms.greedy_nms_mask_plain(
        boxes, scores, thr, normalized, eta), reps=2, warmup=1)
    return dict(problems=int(scores.numel() // k), k=k,
                normalized=normalized, eta=eta, iou_threshold=thr,
                valid_per_problem=sum(valid) / len(valid),
                kept=int(got.sum()), masks_bit_equal=torch.equal(got, want),
                mismatches=int((got != want).sum()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                iou_tests=pairs, bytes=nbytes, library_ms=None)


def nms_kernel_phase(torch, nms):
    """The greedy NMS kernel against its plain version: NMS_PROBLEMS
    problems at each K of NMS_KS, unit and pixel boxes, each (threshold,
    eta) of NMS_THRESHOLDS, from numpy seed 0. Launches here are
    comparisons: not counted on any path."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    cases = []
    for k in NMS_KS:
        for normalized in (True, False):
            boxes, scores = nms_candidates(np, rng, NMS_PROBLEMS, k,
                                           normalized)
            bx = torch.from_numpy(boxes).cuda()
            sc = torch.from_numpy(scores).cuda()
            for thr, eta in NMS_THRESHOLDS:
                cases.append(_nms_case(torch, nms, bx, sc, normalized, thr,
                                       eta))
            del bx, sc
    for c in cases:
        emit({"nms_kernel_case": c})
    bad = [c for c in cases if not c["masks_bit_equal"]]
    if bad:
        fail(f"the NMS kernel's keep mask differs from the plain "
             f"version's: {bad}")
    return cases


def _yolo_graph_vs_eager(torch, step, model, x, y):
    """From one start state: the first call and 2 replays at this shape
    against 3 eager steps (losses, every parameter, every running
    statistic)."""
    s0 = _to_cpu(step.state_dict())
    seeds = STEP_SEEDS[:YOLO_CHECK_STEPS]
    graph = [float(step(x, y, seed=sd)) for sd in seeds]
    gp, gs = _snapshot(step), _running_stats(model)
    step.set_state_dict(s0)
    eager = [float(step.eager_step(x, y, seed=sd)) for sd in seeds]
    ep, es = _snapshot(step), _running_stats(model)
    return dict(steps=YOLO_CHECK_STEPS, graph_losses=graph,
                eager_losses=eager, losses_bit_equal=graph == eager,
                params_bit_equal=_bit_equal(gp, ep),
                params_max_abs_diff=_max_abs_diff(gp, ep),
                buffers_bit_equal=_bit_equal(gs, es),
                buffers_max_abs_diff=_max_abs_diff(gs, es))


def yolo_cpu_check(torch, pt):
    """YOLOv3 at width 4, 4 classes, 2x3x64x64, f32, from the same
    weights: 3 Adam TrainStep steps on the card (captured) and on the
    CPU, each card step started from the CPU step's state: every loss,
    parameter and running statistic within YOLO_CPU_RTOL (relative to
    max(1, max|cpu|))."""
    import numpy as np
    c = YOLO_CPU
    kw = dict(num_classes=c["num_classes"], width=c["width"])
    cpu = _yolo(pt, "cpu", **kw)
    card = _yolo(pt, "cuda", **kw)
    card.set_state_dict({k: v.detach() for k, v in cpu.state_dict().items()})
    s_cpu = _yolo_step(pt, cpu, amp=False)
    s_card = _yolo_step(pt, card, amp=False)
    arrays = yolo_synth_batch(np, np.random.RandomState(SEED), c["batch"],
                              c["size"], classes=c["num_classes"])
    xc, yc = _yolo_on(torch, arrays, "cpu")
    xg, yg = _yolo_on(torch, arrays, "cuda")
    losses, params, stats = [], [], []
    for _ in range(YOLO_CHECK_STEPS):
        s_card.set_state_dict(s_cpu.state_dict())
        lg, lc = float(s_card(xg, yg)), float(s_cpu(xc, yc))
        losses.append(_rel_diff(lg, lc))
        params.append(_max_rel(_snapshot(s_card), _snapshot(s_cpu)))
        stats.append(_max_rel(_running_stats(card), _running_stats(cpu)))
    graphs = s_card.programs
    s_card.release()
    return dict(width=c["width"], classes=c["num_classes"],
                batch=c["batch"], size=c["size"], dtype="float32",
                steps=YOLO_CHECK_STEPS,
                started_from="the CPU step's state, each step",
                loss_rel_diff=losses, params_max_rel=params,
                running_stats_max_rel=stats, card_graphs=graphs,
                max_rel=max(losses + params + stats), rtol=YOLO_CPU_RTOL)


def yolo_train_gates(row):
    """The yolo_train phase's failures, each a message (empty: ok)."""
    bad = []
    for size, cap in row["captured_vs_eager"].items():
        if not (cap["losses_bit_equal"] and cap["params_bit_equal"]
                and cap["buffers_bit_equal"]):
            bad.append(f"the replay at {size} is not bit-equal to the "
                       f"eager step: {cap}")
    if row["graphs"] != len(YOLO_SIZES) or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   f"sentinel events for {len(YOLO_SIZES)} buckets")
    if not row["card_vs_cpu"]["max_rel"] <= YOLO_CPU_RTOL:
        bad.append(f"card and CPU differ: {row['card_vs_cpu']}")
    if not all(math.isfinite(v) for v in row["losses"]):
        bad.append(f"non-finite losses {row['losses']}")
    if not all(0 < r["mfu"] < 1 for r in row["by_size"].values()):
        bad.append("MFU outside (0, 1): " + str(
            {k: r["mfu"] for k, r in row["by_size"].items()}))
    if any(row["flash_launches"].values()) or row["nms_launches"]:
        bad.append(f"the training path launched attention or NMS "
                   f"kernels: {row['flash_launches']}, "
                   f"{row['nms_launches']}")
    return bad


def yolo_train_phase(torch, pt, fa, nms):
    """BASELINE config 4's training: YOLOv3() + Adam + TrainStep(O1 bf16)
    over two size buckets (see the module's notes, phase 33). Returns
    (row, model): the model, trained, goes on to yolo_serve."""
    import numpy as np
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = _yolo(pt, "cuda")
    macs = {s: sum(layer_macs(torch, model, (1, 3, s, s), "cuda").values())
            for s in YOLO_SIZES}
    step = _yolo_step(pt, model)
    # one program a bucket is the contract: the sentinel fires past it
    step.recompile_sentinel.observe(0, expected=len(YOLO_SIZES))
    rng = np.random.RandomState(SEED)
    data = {s: _yolo_on(torch, yolo_synth_batch(np, rng, YOLO_BATCH, s),
                        "cuda") for s in YOLO_SIZES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa)
    nms.launches["nms_greedy"] = 0
    cap, losses = {}, []
    for s in YOLO_SIZES:
        x, y = data[s]
        cap[s] = _yolo_graph_vs_eager(torch, step, model, x, y)
        losses += cap[s]["graph_losses"]
    peak = torch.cuda.max_memory_allocated()
    for i in range(YOLO_ALTERNATE):
        x, y = data[YOLO_SIZES[i % len(YOLO_SIZES)]]
        losses.append(float(step(x, y)))
    flash, nms_count = dict(fa.launches), nms.launches["nms_greedy"]
    by_size = {}
    for s in YOLO_SIZES:
        x, y = data[s]
        secs, last = _resnet_replays(torch, step, x, y, YOLO_WARMUP,
                                    YOLO_STEPS)
        prof = profile_step(torch, step, x, y)
        step_ms = secs / YOLO_STEPS * 1e3
        flops = train_flops(macs[s], YOLO_BATCH)
        by_size[s] = dict(
            step_ms=step_ms, images_per_s=YOLO_BATCH * YOLO_STEPS / secs,
            device_ms_per_step=prof["device_ms"],
            idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
            kernel_launches_per_replay=prof["events"],
            macs_per_image=macs[s], flops_per_step=flops,
            mfu=flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
            mfu_device=flops / (prof["device_ms"] / 1e3)
            / PEAK_FLOPS["bfloat16"],
            last_loss=last, profile=_profile_row(prof, top=12))
    row = dict(card=nvidia_smi(), model="yolov3 (darknet-tiny, width 16)",
               classes=YOLO_CLASSES, batch=YOLO_BATCH, sizes=YOLO_SIZES,
               gt_slots=YOLO_SLOTS, amp="O1 bfloat16",
               optimizer=f"Adam({YOLO_LR})",
               params=sum(p.numel() for p in step.params),
               captured_vs_eager=cap, graphs=step.programs,
               captures=step.captures, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               flash_launches=flash, nms_launches=nms_count,
               losses=losses, warmup_steps=YOLO_WARMUP,
               timed_steps=YOLO_STEPS, by_size=by_size,
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base)
    step.release()
    del step, data
    torch.cuda.empty_cache()
    row["card_vs_cpu"] = yolo_cpu_check(torch, pt)
    row["seconds"] = time.perf_counter() - t0
    emit({"yolo_train": row})
    bad = yolo_train_gates(row)
    if bad:
        fail("yolo_train: " + "; ".join(bad))
    return row, model


def yolo_fit_sizes(np, n=YOLO_FIT_IMAGES, seed=SEED):
    """n image sizes from YOLO_SCALES: half at the smallest (the 320
    bucket holds only it), the rest uniform over the others."""
    rest = len(YOLO_SCALES) - 1
    p = [0.5] + [0.5 / rest] * rest
    return [int(v) for v in np.random.RandomState(seed).choice(
        YOLO_SCALES, size=n, p=p)]


def yolo_pad_collate(np, buckets=tuple(sorted(YOLO_SIZES))):
    """collate of (image [3, s, s], boxes [slots, 4], labels [slots])
    samples: each image padded at the bottom and the right to the
    smallest bucket that holds the batch's largest, its normalised cx,
    cy, w, h scaled by s / canvas to stay on the same pixels."""
    def collate(samples):
        size = max(int(s[0].shape[-1]) for s in samples)
        canvas = next(b for b in buckets if b >= size)
        imgs = np.zeros((len(samples), 3, canvas, canvas), np.float32)
        boxes = np.stack([s[1] for s in samples]).astype(np.float32)
        labels = np.stack([s[2] for s in samples])
        for i, (img, _, _) in enumerate(samples):
            s = int(img.shape[-1])
            imgs[i, :, :s, :s] = img
            boxes[i] *= np.float32(s / canvas)
        return imgs, boxes, labels
    return collate


def yolo_fit_gates(row):
    bad = []
    if row["graphs"] != len(YOLO_SIZES) or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events")
    if not row["losses"] or not all(math.isfinite(v) for v in row["losses"]):
        bad.append(f"fit's losses {row['losses']}")
    if not math.isfinite(row["eval_loss"]):
        bad.append(f"evaluate's loss {row['eval_loss']}")
    if row["batches"] != row["expected_batches"]:
        bad.append(f"{row['batches']} batches, the sampler has "
                   f"{row['expected_batches']}")
    return bad


def yolo_fit_phase(torch, pt, train_row):
    """hapi.Model.fit over io.DataLoader and io.BucketBatchSampler (see
    the module's notes, phase 34)."""
    import numpy as np
    from paddle_tpu_torch import hapi, io
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import InputSpec
    t0 = time.perf_counter()
    sizes = yolo_fit_sizes(np)

    class Images(io.Dataset):
        """Image i: YOLO_FIT_IMAGES synthetic images made in the loader's
        workers from numpy seed SEED + 1 + i."""

        def __len__(self):
            return len(sizes)

        def __getitem__(self, i):
            rng = np.random.RandomState(SEED + 1 + i)
            imgs, box, lbl = yolo_synth_batch(np, rng, 1, sizes[i])
            return imgs[0], box[0], lbl[0]

    sampler = io.BucketBatchSampler(lengths=sizes,
                                    boundaries=sorted(YOLO_SIZES),
                                    batch_size=YOLO_BATCH, drop_last=True)
    loader = io.DataLoader(Images(), batch_sampler=sampler,
                           collate_fn=yolo_pad_collate(np), num_workers=2)
    net = _yolo(pt, "cuda")
    model = hapi.Model(
        net, inputs=[InputSpec([None, 3, None, None], "float32", "img")],
        labels=[InputSpec([None, YOLO_SLOTS, 4], "float32", "gt_box"),
                InputSpec([None, YOLO_SLOTS], "int32", "gt_label")])
    model.prepare(Adam(learning_rate=YOLO_LR, parameters=net.parameters()),
                  loss=lambda p5, p4, p3, box, lbl: net.loss((p5, p4, p3),
                                                             box, lbl),
                  amp_configs="O1")
    step = model._train_step
    step.recompile_sentinel.observe(0, expected=len(YOLO_SIZES))
    marks = []

    class Clock(hapi.Callback):
        def on_train_begin(self, logs=None):
            marks.append((time.perf_counter(), step.captures, None))

        def on_train_batch_end(self, n, logs=None):
            marks.append((time.perf_counter(), step.captures,
                          logs["loss"][0]))

    fit_t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[Clock()])
    fit_s = time.perf_counter() - fit_t0
    replay_s = sum(b[0] - a[0] for a, b in zip(marks, marks[1:])
                   if b[1] == a[1])
    replays = sum(1 for a, b in zip(marks, marks[1:]) if b[1] == a[1])
    ev = model.evaluate(loader, verbose=0)
    row = dict(images=len(sizes), sizes_drawn={s: sizes.count(s)
                                               for s in sorted(set(sizes))},
               buckets=sorted(YOLO_SIZES), batch=YOLO_BATCH, workers=2,
               batches=len(marks) - 1, expected_batches=len(sampler),
               losses=[m[2] for m in marks[1:]], graphs=step.programs,
               captures=step.captures,
               sentinel_events=step.recompile_sentinel.fired,
               fit_seconds=fit_s,
               fit_images_per_s_replayed=(YOLO_BATCH * replays / replay_s
                                          if replay_s else None),
               replayed_batches=replays, eval_loss=ev["loss"][0],
               train_images_per_s={s: train_row["by_size"][s]
                                   ["images_per_s"] for s in YOLO_SIZES})
    step.release()
    del model, net, step
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    emit({"yolo_fit": row})
    bad = yolo_fit_gates(row)
    if bad:
        fail("yolo_fit: " + "; ".join(bad))
    return row


def yolo_serve_gates(row):
    bad = []
    if row["launches_per_hard_predict"] != 1:
        bad.append(f"a hard predict launched the NMS kernel "
                   f"{row['launches_per_hard_predict']} times")
    cmp = row["kernel_vs_plain"]
    if not all(cmp[k] for k in ("masks_bit_equal", "rows_bit_equal",
                                "counts_bit_equal", "index_bit_equal")):
        bad.append(f"the NMS kernel's outputs differ from the plain "
                   f"version's: {cmp}")
    if not row["finite"]:
        bad.append("non-finite detections")
    if any(row["flash_launches"].values()):
        bad.append(f"serving launched attention kernels: "
                   f"{row['flash_launches']}")
    return bad


def yolo_serve_phase(torch, pt, fa, nms, model):
    """YOLOv3 serving (see the module's notes, phase 35)."""
    import numpy as np
    from paddle_tpu_torch.ops import detection as det
    t0 = time.perf_counter()
    c = YOLO_SERVE
    model.eval()
    rng = np.random.RandomState(SEED + 7)
    x = torch.from_numpy(rng.randn(c["batch"], 3, c["size"], c["size"])
                         .astype(np.float32) * 0.1).cuda()
    im = torch.full((c["batch"], 2), c["size"], dtype=torch.int32,
                    device="cuda")
    kw = dict(conf_thresh=c["conf_thresh"], nms_threshold=c["nms_threshold"],
              keep_top_k=c["keep_top_k"])
    with torch.no_grad():
        outs = model(x)
        torch.cuda.synchronize()
        _zero(fa)
        nms.launches["nms_greedy"] = 0
        dets, counts = model.predict(outs, im, nms_type="hard", **kw)
        torch.cuda.synchronize()
        launches = nms.launches["nms_greedy"]
        flash = dict(fa.launches)
        mdets, mcounts = model.predict(outs, im, nms_type="matrix", **kw)
        allb, alls = model.decode(outs, im, c["conf_thresh"])
        s, _, b, _ = det._per_class(allb, alls, c["nms_top_k"])
        sm = torch.where(s > c["conf_thresh"], s,
                         torch.full((), float("-inf"), device="cuda"))
        keep_k = nms.greedy_nms_mask(b, sm, c["nms_threshold"], False, 1.0)
        keep_p = nms.greedy_nms_mask_plain(b, sm, c["nms_threshold"], False,
                                           1.0)
        mc = dict(score_threshold=c["conf_thresh"],
                  nms_threshold=c["nms_threshold"],
                  keep_top_k=c["keep_top_k"], nms_top_k=c["nms_top_k"],
                  background_label=-1, normalized=False, return_index=True)
        out_k = det.multiclass_nms(allb, alls, **mc)
        kernel_fn = det.greedy_nms_mask
        det.greedy_nms_mask = nms.greedy_nms_mask_plain
        try:
            out_p = det.multiclass_nms(allb, alls, **mc)
        finally:
            det.greedy_nms_mask = kernel_fn
        valid = (sm > float("-inf")).sum(-1).flatten().tolist()
        bound, by, pairs, nbytes = nms_bound(valid, sm.shape[-1])
        ms = dict(
            forward=time_ms(lambda: model(x), reps=10),
            decode=time_ms(lambda: model.decode(outs, im,
                                                c["conf_thresh"]), reps=10),
            per_class_top_k=time_ms(lambda: det._per_class(
                allb, alls, c["nms_top_k"]), reps=10),
            nms_kernel=time_ms(lambda: nms.greedy_nms_mask(
                b, sm, c["nms_threshold"], False, 1.0), reps=20),
            nms_plain=time_ms(lambda: nms.greedy_nms_mask_plain(
                b, sm, c["nms_threshold"], False, 1.0), reps=2, warmup=1),
            multiclass_nms=time_ms(lambda: det.multiclass_nms(
                allb, alls, **mc), reps=10),
            matrix_nms=time_ms(lambda: det.matrix_nms(
                allb, alls, score_threshold=c["conf_thresh"],
                post_threshold=c["conf_thresh"],
                keep_top_k=c["keep_top_k"], background_label=-1,
                normalized=False), reps=5),
            predict_hard=time_ms(lambda: model.predict(
                outs, im, nms_type="hard", **kw), reps=10),
            predict_matrix=time_ms(lambda: model.predict(
                outs, im, nms_type="matrix", **kw), reps=5))
    ms["hard_total_with_forward"] = ms["forward"] + ms["predict_hard"]
    row = dict(card=nvidia_smi(), batch=c["batch"], size=c["size"],
               config=c, candidates=int(alls.shape[-1]),
               problems=int(s.shape[0] * s.shape[1]), k=int(s.shape[-1]),
               valid_per_problem=sum(valid) / len(valid),
               launches_per_hard_predict=launches, flash_launches=flash,
               detections_hard=counts.tolist(),
               detections_matrix=mcounts.tolist(),
               finite=bool(torch.isfinite(dets).all()
                           and torch.isfinite(mdets).all()),
               ms_per_batch=ms,
               kernel_vs_plain=dict(
                   masks_bit_equal=torch.equal(keep_k, keep_p),
                   mismatches=int((keep_k != keep_p).sum()),
                   rows_bit_equal=torch.equal(out_k[0], out_p[0]),
                   counts_bit_equal=torch.equal(out_k[1], out_p[1]),
                   index_bit_equal=torch.equal(out_k[2], out_p[2])),
               nms_bound_ms=bound, nms_bound_by=by, nms_iou_tests=pairs,
               nms_bytes=nbytes, seconds=time.perf_counter() - t0)
    emit({"yolo_serve": row})
    bad = yolo_serve_gates(row)
    if bad:
        fail("yolo_serve: " + "; ".join(bad))
    return row


OPS_CASES = os.path.join("tests", "torch_ops_cases.py")


def load_ops_cases():
    """tests/torch_ops_cases.py (numpy only): the op library's parity
    table, the one tests/test_torch_ops_*.py hold against the JAX
    package on the CPU."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_ops_cases", os.path.join(REPO, OPS_CASES))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def ops_case_run(torch, pt, cases, case, device):
    """One case of the table through the port on `device` (the current
    place set to it, so the creation ops land there too): the outputs as
    numpy, each tensor output's device type and, for a differentiable
    case, the gradients of sum(out * w) (w drawn after the inputs from
    the case's generator, as the CPU tests draw it)."""
    import numpy as np
    args, kwargs, rng = case.inputs()
    grads = [] if case.grad else None

    def conv(v):
        if isinstance(v, cases.ARG):
            return v.value
        if isinstance(v, list):
            return [conv(a) for a in v]
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.array(v)).to(device)
            if grads is not None and v.dtype == np.float32:
                t.requires_grad_(True)
                grads.append(t)
            return t
        return v

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().resolve_conj().resolve_neg().numpy()
        return np.asarray(x)
    pt.set_device(device)
    fn = functools.reduce(getattr, case.fn.split("."), pt)
    out = fn(*[conv(v) for v in args],
             **{n: conv(v) for n, v in kwargs.items()})
    leaves = _leaves(out)
    res = dict(out=[host(o) for o in leaves],
               devices=[o.device.type for o in leaves
                        if isinstance(o, torch.Tensor)])
    if case.grad:
        loss = None
        for o in leaves:
            if isinstance(o, torch.Tensor) and o.is_floating_point():
                w = np.asarray(rng.randn(*o.shape), np.float32)
                if o.requires_grad:
                    term = (o * torch.from_numpy(w).to(o.device)).sum()
                    loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        res["grads"] = [None if t.grad is None else host(t.grad)
                        for t in grads]
    return res


def ops_close(np, got, want, tol):
    """(error text or None, the largest err / (tol x max(1, |want|))):
    floats within tol x max(1, |want|) elementwise (NaN and infinities
    where want has them), integers and bools exactly, the same shape and
    dtype."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.shape} {got.dtype} vs {want.shape} {want.dtype}", \
            math.inf
    if want.dtype.kind not in "fc":
        return (None, 0.0) if np.array_equal(got, want) else \
            (f"{got.tolist()} vs {want.tolist()}", math.inf)
    g, w = got.astype(np.complex128), want.astype(np.complex128)
    nan = np.isnan(w)
    if not np.array_equal(np.isnan(g), nan):
        return "NaN positions differ", math.inf
    g, w = g[~nan], w[~nan]
    inf = np.isinf(w)
    if not np.array_equal(g[inf], w[inf]):
        return "infinities differ", math.inf
    err = np.abs(g[~inf] - w[~inf]) / (tol * np.maximum(1.0, np.abs(w[~inf])))
    ratio = float(err.max()) if err.size else 0.0
    return (None, ratio) if ratio <= 1.0 else \
        (f"max err {ratio:.3g} x the limit", ratio)


def ops_random_check(torch, pt, cases):
    """Each random op on the card: on the card, the shape asked for,
    and paddle.seed reproducing the draw."""
    draws = {"rand": lambda: pt.rand([64, 32]),
             "randn": lambda: pt.randn([64, 32]),
             "standard_normal": lambda: pt.standard_normal([64, 32]),
             "uniform": lambda: pt.uniform([64, 32], min=-2.0, max=3.0),
             "normal": lambda: pt.normal(1.0, 2.0, [64, 32]),
             "randint": lambda: pt.randint(0, 9, [64, 32]),
             "randperm": lambda: pt.randperm(2048).reshape(64, 32),
             "bernoulli": lambda: pt.bernoulli(
                 torch.full((64, 32), 0.3, device="cuda")),
             "multinomial": lambda: pt.multinomial(
                 torch.full((64, 40), 0.025, device="cuda"), 32)}
    bad = [n for n in cases.RANDOM if n not in draws]
    for name, fn in draws.items():
        pt.seed(SEED)
        a = fn()
        pt.seed(SEED)
        b = fn()
        if a.device.type != "cuda" or tuple(a.shape) != (64, 32) \
                or not torch.equal(a, b):
            bad.append(f"{name}: {a.device} {tuple(a.shape)} "
                       f"reproduced {torch.equal(a, b)}")
    return bad


def ops_card_phase(torch, pt):
    """Every case of the op library's parity table on the card against
    the same case on the CPU, at the table's tolerances, and every
    tensor output on the card (see the module's notes, phase 36)."""
    import numpy as np
    from paddle_tpu_torch.core import place as _place
    t0 = time.perf_counter()
    cases = load_ops_cases()
    saved = _place._current_place
    bad, worst, modules = [], {}, {}
    try:
        for case in cases.CASES:
            card = ops_case_run(torch, pt, cases, case, "cuda")
            cpu = ops_case_run(torch, pt, cases, case, "cpu")
            modules[case.module] = modules.get(case.module, 0) + 1
            off = [d for d in card["devices"] if d != "cuda"]
            if off:
                bad.append(f"{case.id}: outputs left on {off}")
            tol = cases.TOLS[case.tol]
            pairs = list(zip(card["out"], cpu["out"]))
            if len(card["out"]) != len(cpu["out"]):
                bad.append(f"{case.id}: {len(card['out'])} outputs vs "
                           f"{len(cpu['out'])}")
            if case.grad:
                pairs += [(g if g is not None else np.zeros_like(c),
                           c if c is not None else np.zeros_like(g))
                          for g, c in zip(card["grads"], cpu["grads"])
                          if g is not None or c is not None]
            for i, (g, c) in enumerate(pairs):
                msg, ratio = ops_close(np, g, c, tol)
                worst[case.tol] = max(worst.get(case.tol, 0.0), ratio)
                if msg:
                    bad.append(f"{case.id}[{i}]: {msg}")
        pt.set_device("cuda")
        bad += ops_random_check(torch, pt, cases)
    finally:
        _place._current_place = saved
    row = dict(cases=len(cases.CASES), by_module=modules,
               random_ops=list(cases.RANDOM), tolerances=cases.TOLS,
               worst_err_over_limit=worst, mismatches=len(bad),
               seconds=time.perf_counter() - t0)
    emit({"ops_card": row})
    if bad:
        fail("ops_card: " + "; ".join(bad[:20]))
    return row


MNIST_SIZES = (60000, 10000)     # MNIST's train and test sets
MNIST_BATCH, MNIST_LR = 64, 1e-3
MNIST_PARITY_STEPS, MNIST_PARITY_RTOL = 20, 1e-4
MNIST_ACC_BAR = 0.5              # tests/test_models_hapi.py:108
MNIST_PROFILED = 20


def mnist_dygraph_gates(row):
    bad = []
    for route in ("eager", "fit"):
        acc = row[route]["test_acc"]
        if not acc > MNIST_ACC_BAR:
            bad.append(f"{route}: test accuracy {acc} after one epoch")
        if not all(math.isfinite(v) for v in row[route]["losses_head"]):
            bad.append(f"{route}: losses {row[route]['losses_head']}")
    if row["card_vs_cpu_max_rel"] > MNIST_PARITY_RTOL:
        bad.append(f"the card's first {MNIST_PARITY_STEPS} steps differ "
                   f"from the CPU's by {row['card_vs_cpu_max_rel']} "
                   "relative")
    if not row["save_load_bit_equal"]:
        bad.append("paddle.save/paddle.load changed the model")
    if any(row["custom_kernel_launches"].values()):
        bad.append(f"launches {row['custom_kernel_launches']}")
    return bad


def mnist_sets(pt):
    """MNIST's train and test sets at their real sizes (the synthetic
    fallback), each image normalised by transforms.Normalize."""
    from paddle_tpu_torch.vision import datasets, transforms
    norm = transforms.Normalize(mean=[127.5], std=[127.5],
                                data_format="CHW")
    return [datasets.MNIST(mode=m, synthetic_size=n, transform=norm)
            for m, n in zip(("train", "test"), MNIST_SIZES)]


def lenet_step(pt, model, opt, x, y):
    """One step of the dygraph loop as Paddle users write it; returns
    the loss (a device tensor, detached, not read back)."""
    import paddle_tpu_torch.nn.functional as F
    loss = pt.mean(F.cross_entropy(model(x), pt.reshape(y, [-1])))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def lenet_test_acc(pt, model, loader):
    """Accuracy over the test set under no_grad: paddle.argmax against
    the labels, and paddle.metric.accuracy on each batch, weighted."""
    hits, seen, metric = 0, 0, 0.0
    with pt.no_grad():
        for x, y in loader:
            out = model(x)
            hits += int(pt.sum(pt.equal(pt.argmax(out, axis=1),
                                        pt.reshape(y, [-1]))))
            metric += float(pt.metric.accuracy(out, pt.reshape(y, [-1, 1]))
                            ) * len(y)
            seen += len(y)
    return hits / seen, metric / seen


def mnist_dygraph_phase(torch, pt, fa, nms, smi):
    """BASELINE config 1: LeNet on MNIST in dygraph, as the eager loop
    and through hapi.Model.fit (see the module's notes, phase 37)."""
    import tempfile
    from paddle_tpu_torch.vision.models import LeNet
    import paddle_tpu_torch.nn.functional as F
    t0 = time.perf_counter()
    _zero(fa)
    nms.launches["nms_greedy"] = 0
    train, test = mnist_sets(pt)
    loader = pt.io.DataLoader(train, batch_size=MNIST_BATCH)
    test_loader = pt.io.DataLoader(test, batch_size=MNIST_BATCH)
    pt.seed(SEED)
    model = LeNet()
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    # the first steps on the CPU from the same weights and batches
    cpu_model = LeNet(device="cpu")
    cpu_model.set_state_dict(start)
    cpu_opt = pt.optimizer.Adam(learning_rate=MNIST_LR,
                                parameters=cpu_model.parameters())
    cpu_losses = []
    for _, (x, y) in zip(range(MNIST_PARITY_STEPS),
                         pt.io.DataLoader(train, batch_size=MNIST_BATCH,
                                          places="cpu")):
        cpu_losses.append(float(lenet_step(pt, cpu_model, cpu_opt, x, y)))
    # the eager epoch on the card
    opt = pt.optimizer.Adam(learning_rate=MNIST_LR,
                            parameters=model.parameters())
    torch.cuda.synchronize()
    e0 = time.perf_counter()
    losses = [lenet_step(pt, model, opt, x, y) for x, y in loader]
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - e0
    losses = [float(v) for v in losses]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in
              zip(losses[:MNIST_PARITY_STEPS], cpu_losses))
    acc, metric_acc = lenet_test_acc(pt, model, test_loader)
    # one step's device time by category, at a fixed batch
    x, y = next(iter(loader))
    prof = device_profile(torch, lambda: lenet_step(pt, model, opt, x, y),
                          MNIST_PROFILED)
    step_ms = time_ms(lambda: lenet_step(pt, model, opt, x, y),
                      MNIST_PROFILED)
    # paddle.save / paddle.load of the state dict
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        path = os.path.join(d, "lenet.pdparams")
        pt.save(model.state_dict(), path)
        again = LeNet()
        again.set_state_dict(pt.load(path))
    with pt.no_grad():
        same = bool(torch.equal(again(x), model(x)))
    del again, cpu_model
    # hapi.Model.fit and evaluate
    pt.seed(SEED)
    net = LeNet()
    hm = pt.Model(net)
    hm.prepare(pt.optimizer.Adam(learning_rate=MNIST_LR,
                                 parameters=net.parameters()),
               lambda o, lbl: F.cross_entropy(o, lbl),
               metrics=[pt.metric.Accuracy()])
    fit_losses = []

    class Losses(pt.callbacks.Callback):
        def on_train_batch_end(self, n, logs=None):
            fit_losses.append(logs["loss"][0])
    # the last batch (60000 % 64 = 32 images) is a second signature
    hm._train_step.recompile_sentinel.observe(0, expected=2)
    torch.cuda.synchronize()
    f0 = time.perf_counter()
    hm.fit(train, epochs=1, batch_size=MNIST_BATCH, verbose=0,
           callbacks=[Losses()])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - f0
    ev = hm.evaluate(test, batch_size=MNIST_BATCH, verbose=0)
    graphs = hm._train_step.programs
    hm._train_step.release()
    launches = dict(fa.launches, **nms.launches)
    n = MNIST_SIZES[0]
    row = dict(
        card=smi, config="LeNet (paddle_tpu/vision/models/lenet.py) on "
        "MNIST 60000/10000 1x28x28, Normalize, batch 64, Adam(1e-3)",
        steps=len(losses),
        eager=dict(images_per_s=n / eager_s, epoch_s=eager_s,
                   losses_head=losses[:5], loss_last=losses[-1],
                   test_acc=acc, metric_accuracy=metric_acc,
                   step_ms_fixed_batch=step_ms,
                   device_ms_per_step=prof["device_ms"],
                   idle_share=1.0 - prof["device_ms"] / step_ms,
                   categories=prof["categories"], top=prof["top"][:8],
                   device_events_per_step=prof["events"]),
        fit=dict(images_per_s=n / fit_s, epoch_s=fit_s,
                 losses_head=fit_losses[:5], loss_last=fit_losses[-1],
                 test_acc=ev["acc"], test_loss=ev["loss"][0],
                 graphs=graphs),
        card_vs_cpu_max_rel=rel, parity_steps=MNIST_PARITY_STEPS,
        save_load_bit_equal=same, custom_kernel_launches=launches,
        seconds=time.perf_counter() - t0)
    emit({"mnist_dygraph": row})
    bad = mnist_dygraph_gates(row)
    if bad:
        fail("mnist_dygraph: " + "; ".join(bad))
    return row


# -- the op library's AMP casts on the card --------------------------------------

# the ops whose JAX op is registered under a name on the AMP lists:
# registered name -> (top-level function, argument shapes; "pos" draws
# from [0.5, 2), a string passes as it is), keywords
AMP_OPS = {
    "exp": ("exp", ["pos"], {}), "log": ("log", ["pos"], {}),
    "log2": ("log2", ["pos"], {}), "log10": ("log10", ["pos"], {}),
    "log1p": ("log1p", ["pos"], {}), "square": ("square", ["pos"], {}),
    "sqrt": ("sqrt", ["pos"], {}), "rsqrt": ("rsqrt", ["pos"], {}),
    "reciprocal": ("reciprocal", ["pos"], {}),
    "elementwise_pow": ("pow", ["pos", "pos"], {}),
    "cumsum": ("cumsum", ["pos"], {"axis": 1}),
    "logsumexp": ("logsumexp", ["pos"], {"axis": 1}),
    "reduce_sum": ("sum", ["pos"], {"axis": 0}),
    "reduce_mean": ("mean", ["pos"], {}),
    "reduce_prod": ("prod", ["pos"], {"axis": 1}),
    "p_norm": ("norm", [(3, 4)], {"p": 2, "axis": 1}),
    "matmul_v2": ("matmul", [(3, 4), (4, 5)], {}),
    "addmm": ("addmm", [(3, 5), (3, 4), (4, 5)], {}),
    "bmm": ("bmm", [(2, 3, 4), (2, 4, 5)], {}),
    "mv": ("mv", [(3, 4), (4,)], {}),
    "einsum": ("einsum", ["ij,jk->ik", (3, 4), (4, 5)], {}),
}


def amp_card_phase(torch, pt):
    """Each AMP_OPS op on the card under auto_cast O1 and O2 (bf16), from
    bf16 and f32 inputs: its output dtype must be the one the AMP lists
    give (O1: white-list ops bf16, black-list f32; O2: black-list f32,
    the others bf16), as the JAX registry's hook casts; outside
    auto_cast, the input dtype."""
    from paddle_tpu_torch.amp.auto_cast import AMP_BLACK_LIST, AMP_WHITE_LIST
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    bad, rows = [], []
    for name, (fn, shapes, kw) in AMP_OPS.items():
        for dt in ("float32", "bfloat16"):
            def make(s):
                if isinstance(s, str) and s != "pos":
                    return s
                if s == "pos":
                    x = torch.rand((3, 4), generator=gen, device="cuda")
                    x = x * 1.5 + 0.5
                else:
                    x = torch.randn(s, generator=gen, device="cuda")
                return x.to(getattr(torch, dt))
            args = [make(s) for s in shapes]
            got = {"none": str(getattr(pt, fn)(*args, **kw).dtype)}
            want = {"none": f"torch.{dt}"}
            for level in ("O1", "O2"):
                with pt.amp.auto_cast(level=level, dtype="bfloat16"):
                    got[level] = str(getattr(pt, fn)(*args, **kw).dtype)
                black = name in AMP_BLACK_LIST
                low = name in AMP_WHITE_LIST if level == "O1" else not black
                want[level] = ("torch.float32" if black else
                               "torch.bfloat16" if low else f"torch.{dt}")
            rows.append(dict(op=name, fn=fn, dtype=dt, got=got))
            if got != want:
                bad.append(f"{name} {dt}: {got} vs {want}")
    emit({"amp_card": dict(ops=len(AMP_OPS), cases=len(rows),
                           device=str(args[-1].device), mismatches=bad)})
    if bad:
        fail("amp_card: " + "; ".join(bad))
    return rows


# -- the rest of paddle.nn: Transformer-base and an LSTM seq2seq -------------------

# Transformer-base as Vaswani et al. (2017) trained it on WMT'14 En-De:
# paddle.nn.Transformer's defaults (d_model 512, 8 heads, 6 + 6 layers,
# FFN 2048, dropout 0.1, ReLU, post-norm), one shared BPE vocabulary of
# about 37,000 tokens, label smoothing 0.1, Adam(0.9, 0.98, 1e-9) under
# the Noam schedule (4000 warm-up steps). Synthetic token ids from the
# seed: one length bucket of 32 pairs, source 128 and target 96 tokens,
# no padding.
MT_VOCAB = 37000
MT_BASE = dict(d_model=512, nhead=8, num_encoder_layers=6,
               num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
MT_BATCH, MT_SRC, MT_TGT = 32, 128, 96
MT_SMOOTH, MT_NOAM_WARMUP = 0.1, 4000
MT_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
MT_BOS = 1                       # ids 0-2: pad, bos, eos; words from 3
MT_WARMUP, MT_STEPS = 2, 10
# card against CPU: the CPU tests' tiny model (MT_TINY, head_dim 8, which
# the kernels run zero-padded to 64), f32, dropout 0, weights from SEED
MT_CPU_SHAPE = dict(vocab=97, batch=3, src=12, tgt=9)
MT_CPU_STEPS, MT_CPU_RTOL = 4, 1e-3
# the CPU tests' tiny MT model
MT_TINY = dict(d_model=32, nhead=4, num_encoder_layers=2,
               num_decoder_layers=2, dim_feedforward=64, dropout=0.0)
# per step: 6 encoder self-attentions and 6 cross-attentions on the
# kernels; the 6 causal decoder self-attentions on SDPA
MT_FLASH_PER_STEP, MT_SDPA_PER_STEP = 12, 6


def sinusoid_table(np, positions, d_model):
    """The fixed sinusoid position table of Vaswani et al. (2017):
    sin at even features, cos at odd, wavelengths 2 pi .. 10000 2 pi."""
    pos = np.arange(positions)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def mt_model(paddle, vocab, max_len, **cfg):
    """A translation model written against the public nn API of
    `paddle` (either package): paddle.nn.Transformer(**cfg), one
    Embedding shared by source and target and scaled by sqrt(d_model),
    the sinusoid table added (a buffer), dropout on the sums, the
    decoder's causal mask from generate_square_subsequent_mask, and the
    output projection tied to the embedding (matmul with transpose_y).
    forward(src, tgt) -> logits [b, t, vocab]."""
    import numpy as np
    nn = paddle.nn
    d = cfg.get("d_model", 512)
    drop = cfg.get("dropout", 0.1)

    class TranslationModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, d)
            self.transformer = nn.Transformer(**cfg)
            self.dropout = nn.Dropout(drop)
            self.register_buffer(
                "pos", paddle.to_tensor(sinusoid_table(np, max_len, d)))

        def embed(self, ids):
            x = self.emb(ids) * math.sqrt(d) + self.pos[:ids.shape[1]]
            return self.dropout(x)

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            h = self.transformer(self.embed(src), self.embed(tgt),
                                 tgt_mask=mask)
            return paddle.matmul(h, self.emb.weight, transpose_y=True)

    return TranslationModel()


def mt_loss(paddle, vocab, epsilon=MT_SMOOTH):
    """Label-smoothed cross entropy: nn.CrossEntropyLoss(soft_label=True)
    over F.label_smooth(F.one_hot(label, vocab), epsilon)."""
    F = paddle.nn.functional
    ce = paddle.nn.CrossEntropyLoss(soft_label=True)

    def loss(logits, label):
        return ce(logits, F.label_smooth(F.one_hot(label, vocab),
                                         epsilon=epsilon))
    return loss


def mt_optimizer(paddle, d_model, warmup, learning_rate=1.0):
    """(Adam(0.9, 0.98, 1e-9), its NoamDecay(d_model, warmup))."""
    sched = paddle.optimizer.lr.NoamDecay(
        d_model=d_model, warmup_steps=warmup, learning_rate=learning_rate)
    return paddle.optimizer.Adam(learning_rate=sched, **MT_ADAM), sched


def mt_batch(np, b, s_src, s_tgt, vocab, seed=SEED):
    """(src [b, s_src], tgt_in [b, s_tgt], tgt_out [b, s_tgt]) int64 word
    ids in [3, vocab) from numpy `seed`; tgt_in is tgt_out shifted right
    behind MT_BOS (teacher forcing)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, vocab, (b, s_src)).astype(np.int64)
    out = rng.randint(3, vocab, (b, s_tgt)).astype(np.int64)
    tin = np.concatenate([np.full((b, 1), MT_BOS, np.int64), out[:, :-1]],
                         1)
    return src, tin, out


def mt_train_flops(b, s_src, s_tgt, vocab, d_model, dim_feedforward,
                   num_encoder_layers, num_decoder_layers, **_):
    """A training step's FLOPs, from the shapes: 2 per multiply-add and 3
    passes (the forward and the backward's two products). Per encoder
    token and layer: q, k, v, out projections 4 d^2, the FFN 2 d ff, and
    QK^T and PV 2 s_src d. Per decoder token and layer: self-attention's
    projections 4 d^2 and products 2 s_tgt d (SDPA computes the masked
    half too), cross-attention's q and out projections 2 d^2 (its k and v
    projections 2 d^2 run on each encoder token) and products 2 s_src d,
    the FFN 2 d ff. The tied output projection d x vocab per target
    token. The embedding gathers, norms, softmaxes and the loss are not
    counted."""
    d, ff = d_model, dim_feedforward
    n_src, n_tgt = b * s_src, b * s_tgt
    enc = num_encoder_layers * n_src * (4 * d * d + 2 * d * ff
                                        + 2 * s_src * d)
    dec = num_decoder_layers * (
        n_tgt * (4 * d * d + 2 * s_tgt * d + 2 * d * d + 2 * s_src * d
                 + 2 * d * ff) + n_src * 2 * d * d)
    head = n_tgt * d * vocab
    macs = enc + dec + head
    return dict(macs_encoder=enc, macs_decoder=dec, macs_head=head,
                macs=macs, flops=3 * 2 * macs)


def transformer_train_gates(row):
    """The transformer_train phase's failures, each a message (empty:
    ok)."""
    bad = []
    cap = row["captured_vs_eager"]
    if not (cap["losses_bit_equal"] and cap["params_bit_equal"]):
        bad.append(f"the replay is not bit-equal to the eager step: {cap}")
    if row["graphs"] != 1 or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events for one signature")
    low = {k: v for k, v in row["launches_per_step"].items()
           if not v >= MT_FLASH_PER_STEP}
    if low:
        bad.append(f"flash kernel launches a step below "
                   f"{MT_FLASH_PER_STEP}: {low}")
    routes = row["routes_per_eager_step"]
    if routes != {"flash_attention": MT_FLASH_PER_STEP,
                  "scaled_dot_product_attention": MT_SDPA_PER_STEP}:
        bad.append(f"attention routes of an eager step: {routes}")
    if not all(math.isfinite(v) for v in row["losses"]):
        bad.append(f"non-finite losses {row['losses']}")
    cpu = row["card_vs_cpu"]
    if not cpu["max_rel"] <= MT_CPU_RTOL:
        bad.append(f"card and CPU differ: {cpu}")
    if not 0 < row["mfu"] < 1:
        bad.append(f"MFU {row['mfu']} outside (0, 1)")
    return bad


class _OnCpu:
    """The port's current place set to the CPU inside, restored after
    (the entry points' default device)."""

    def __enter__(self):
        from paddle_tpu_torch.core import place
        self.saved = place._current_place
        place.set_device("cpu")

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import place
        place._current_place = self.saved


class _CountCalls:
    """Counts the calls of functions of a module while active (the
    attention routes MultiHeadAttention takes: it calls them through
    the nn.functional module)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.counts = {n: 0 for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            def wrap(*a, _n=n, **k):
                self.counts[_n] += 1
                return self.saved[_n](*a, **k)
            setattr(self.module, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def _mt_step(torch, pt, cfg, vocab, batch, device, amp=True, seed=SEED):
    """(model, TrainStep, its NoamDecay, (src, tgt_in), (tgt_out,)) of
    mt_model at `cfg` on `device`, weights from `seed`,
    Noam(d_model, MT_NOAM_WARMUP)."""
    import numpy as np
    from paddle_tpu_torch.static import TrainStep
    b, s, t = batch
    pt.seed(seed)
    model = mt_model(pt, vocab, max(s, t), **cfg)
    opt, sched = mt_optimizer(pt, cfg["d_model"], MT_NOAM_WARMUP)
    kw = dict(amp_level="O1", amp_dtype="bfloat16") if amp else {}
    step = TrainStep(model, mt_loss(pt, vocab), opt, **kw)
    src, tin, tout = (torch.from_numpy(a).to(device)
                      for a in mt_batch(np, b, s, t, vocab))
    return model, step, sched, (src, tin), (tout,)


def transformer_cpu_check(torch, pt):
    """mt_model at MT_TINY (head_dim 8), f32, dropout 0, weights from
    SEED: MT_CPU_STEPS TrainStep steps on the card (captured) and on the
    CPU (eager) from the same weights and batch, the scheduler stepped
    after each: every loss within MT_CPU_RTOL relative. The card's
    attention runs the f32 kernels at head_dim 8 padded to 64, at (sq
    12, sk 12) and, cross, (9, 12)."""
    sh = MT_CPU_SHAPE
    batch = (sh["batch"], sh["src"], sh["tgt"])
    with _OnCpu():
        cpu_model, cpu, cpu_sched, cx, cy = _mt_step(
            torch, pt, MT_TINY, sh["vocab"], batch, "cpu", amp=False)
    card_model, card, card_sched, gx, gy = _mt_step(
        torch, pt, MT_TINY, sh["vocab"], batch, "cuda", amp=False)
    card_model.set_state_dict({k: v.detach() for k, v in
                               cpu_model.state_dict().items()})
    losses = {"card": [], "cpu": []}
    for _ in range(MT_CPU_STEPS):
        losses["card"].append(float(card(gx, gy)))
        with _OnCpu():
            losses["cpu"].append(float(cpu(cx, cy)))
        card_sched.step()
        cpu_sched.step()
    graphs = card.programs
    card.release()
    rel = [_rel_diff(a, c) for a, c in zip(losses["card"], losses["cpu"])]
    return dict(config=dict(MT_TINY, **sh), dtype="float32",
                steps=MT_CPU_STEPS, losses_card=losses["card"],
                losses_cpu=losses["cpu"], loss_rel_diff=rel,
                max_rel=max(rel), card_graphs=graphs, rtol=MT_CPU_RTOL)


def transformer_train_phase(torch, pt, fa):
    """Transformer-base (MT_BASE, vocab MT_VOCAB, ~63 M parameters)
    trained through the captured TrainStep, O1 bf16, at MT_BATCH pairs
    of MT_SRC source and MT_TGT target tokens. From one start state the
    first call and 3 replays against 4 eager steps at STEP_SEEDS:
    losses and every parameter bit-equal. The attention routes of an
    eager step counted at nn.functional (MT_FLASH_PER_STEP calls of
    flash_attention, MT_SDPA_PER_STEP of scaled_dot_product_attention);
    the kernels a replay launches counted on the card by torch.profiler
    (profile_step). Then MT_WARMUP + MT_STEPS replays on a synchronised
    host clock, the scheduler stepped after each: step ms beside the
    device ms of a replay and its categories, the idle share, source and
    target tokens/s, MFU from mt_train_flops, peak memory over the first
    call. Last, transformer_cpu_check."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model, step, sched, x, y = _mt_step(torch, pt, MT_BASE, MT_VOCAB,
                                        (MT_BATCH, MT_SRC, MT_TGT), "cuda")
    s0 = _to_cpu(step.state_dict())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(fa)
    graph_losses = []
    for sd in STEP_SEEDS:
        graph_losses.append(float(step(x, y, seed=sd)))
        if len(graph_losses) == 1:
            warm = dict(step.last_launches)
            peak = torch.cuda.max_memory_allocated()
    graph_params = _snapshot(step)
    step.set_state_dict(s0)
    F = pt.nn.functional
    with _CountCalls(F, ("flash_attention",
                         "scaled_dot_product_attention")) as routes:
        eager_losses = [float(step.eager_step(x, y, seed=sd))
                        for sd in STEP_SEEDS]
    eager_params = _snapshot(step)
    cap = dict(steps=len(STEP_SEEDS), step_seeds=STEP_SEEDS,
               graph_losses=graph_losses, eager_losses=eager_losses,
               losses_bit_equal=graph_losses == eager_losses,
               params_bit_equal=_bit_equal(graph_params, eager_params),
               params_max_abs_diff=_max_abs_diff(graph_params, eager_params))
    del graph_params, eager_params
    eager_ms = time_ms(lambda: step.eager_step(x, y), reps=3, warmup=1)
    for _ in range(MT_WARMUP):
        step(x, y)
        sched.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(MT_STEPS):
        last = step(x, y)
        sched.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    prof = profile_step(torch, step, x, y)
    step_ms = secs / MT_STEPS * 1e3
    work = mt_train_flops(MT_BATCH, MT_SRC, MT_TGT, MT_VOCAB, **MT_BASE)
    row = dict(card=nvidia_smi(), model="Transformer-base",
               config=dict(MT_BASE, vocab=MT_VOCAB, tied_embeddings=True),
               batch=MT_BATCH, src_len=MT_SRC, tgt_len=MT_TGT,
               amp="O1 bfloat16", optimizer="Adam(0.9, 0.98, 1e-9), "
               f"NoamDecay(512, {MT_NOAM_WARMUP})",
               params=sum(p.numel() for p in step.params),
               captured_vs_eager=cap, graphs=step.programs,
               captures=step.captures, replays=step.replays,
               sentinel_events=step.recompile_sentinel.fired,
               routes_per_eager_step={k: v // len(STEP_SEEDS)
                                      for k, v in routes.counts.items()},
               warmup_launches=warm,
               launches_per_step=prof["launches_per_replay"],
               launches=_sum_launches([warm, prof["kernel_launches"]]),
               counted_calls=COUNTED_CALLS,
               losses=graph_losses + [float(last)],
               warmup_steps=MT_WARMUP, timed_steps=MT_STEPS,
               step_ms=step_ms, eager_step_ms=eager_ms,
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               tgt_tokens_per_s=MT_BATCH * MT_TGT * MT_STEPS / secs,
               src_tokens_per_s=MT_BATCH * MT_SRC * MT_STEPS / secs,
               work=work, mfu=work["flops"] / (step_ms / 1e3)
               / PEAK_FLOPS["bfloat16"],
               mfu_device=work["flops"] / (prof["device_ms"] / 1e3)
               / PEAK_FLOPS["bfloat16"],
               peak_memory_bytes=peak, peak_above_base_bytes=peak - base,
               kernel_launches_per_replay=prof["events"],
               profile=_profile_row(prof, top=12))
    step.release()
    del model, step, x, y
    torch.cuda.empty_cache()
    row["card_vs_cpu"] = transformer_cpu_check(torch, pt)
    row["seconds"] = time.perf_counter() - t0
    emit({"transformer_train": row})
    bad = transformer_train_gates(row)
    if bad:
        fail("transformer_train: " + "; ".join(bad))
    return row


# An LSTM encoder-decoder at the widths of PaddleNLP's
# machine_translation/seq2seq example on IWSLT'15 En-Vi (vocabularies
# 17,191 and 7,709, embeddings and hidden 512, 2 layers, dropout 0.2,
# Adam(1e-3), global-norm clip 5.0, beam 10); the example's attention is
# user code outside paddle.nn and is left out. Synthetic token ids from
# the seed, batch 64 of 50 source and 50 target tokens.
S2S = dict(src_vocab=17191, tgt_vocab=7709, hidden=512, layers=2,
           dropout=0.2)
S2S_BATCH, S2S_LEN = 64, 50
S2S_LR, S2S_CLIP = 1e-3, 5.0
S2S_STEPS = 3
S2S_BEAM, S2S_MAX_STEPS = 10, 50
S2S_BOS, S2S_EOS = 1, 2
S2S_RTOL = 1e-3
# a near-tie: a best-beam lead within S2S_TIE_FACTOR times the two
# devices' largest score difference; a re-score off its beam's score by
# as many times that and the re-scoring's own (decode_agreement)
S2S_TIE_FACTOR = 10
# the CPU tests' tiny seq2seq
S2S_TINY = dict(src_vocab=23, tgt_vocab=11, hidden=8, layers=2, dropout=0.0)


def seq2seq_model(paddle, src_vocab, tgt_vocab, hidden, layers, dropout):
    """An LSTM encoder-decoder written against the public nn API of
    `paddle` (either package): Embedding(src_vocab, hidden) into
    LSTM(hidden, hidden, layers, dropout); the decoder an
    Embedding(tgt_vocab, hidden), one LSTMCell(hidden, hidden) run by
    nn.RNN (teacher forcing) and seeded with the top encoder layer's
    final (h, c), and Linear(hidden, tgt_vocab). forward(src, tgt_in) ->
    logits [b, t, tgt_vocab]; encode(src) -> the decoder's first
    state."""
    nn = paddle.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(src_vocab, hidden)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
            self.tgt_emb = nn.Embedding(tgt_vocab, hidden)
            self.decoder = nn.RNN(nn.LSTMCell(hidden, hidden))
            self.out = nn.Linear(hidden, tgt_vocab)

        def encode(self, src):
            _, (h, c) = self.encoder(self.src_emb(src))
            return h[-1], c[-1]

        def forward(self, src, tgt_in):
            y, _ = self.decoder(self.tgt_emb(tgt_in), self.encode(src))
            return self.out(y)

    return Seq2Seq()


def seq2seq_batch(np, b, s, t, src_vocab, tgt_vocab, seed=SEED):
    """(src [b, s], tgt_in [b, t], tgt_out [b, t]) int64 word ids from 3
    up, from numpy `seed`; tgt_in is tgt_out shifted right behind
    S2S_BOS."""
    rng = np.random.RandomState(seed)
    src = rng.randint(3, src_vocab, (b, s)).astype(np.int64)
    out = rng.randint(3, tgt_vocab, (b, t)).astype(np.int64)
    tin = np.concatenate([np.full((b, 1), S2S_BOS, np.int64), out[:, :-1]],
                         1)
    return src, tin, out


def seq2seq_train(paddle, model, batch, steps, lr=S2S_LR, clip=S2S_CLIP):
    """`steps` eager teacher-forced steps on one batch (src, tgt_in,
    tgt_out tensors): nn.CrossEntropyLoss, Adam(lr) with
    ClipGradByGlobalNorm(clip); the losses as floats."""
    ce = paddle.nn.CrossEntropyLoss()
    opt = paddle.optimizer.Adam(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(clip))
    src, tin, tout = batch
    losses = []
    for _ in range(steps):
        loss = ce(model(src, tin), tout)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def beam_decode(paddle, model, src, beam=S2S_BEAM, max_steps=S2S_MAX_STEPS):
    """dynamic_decode of a BeamSearchDecoder over the decoder's cell (the
    target embedding in, the output Linear out), from encode(src):
    (ids [b, T, beam], final scores [b, beam])."""
    nn = paddle.nn
    dec = nn.BeamSearchDecoder(model.decoder.cell, start_token=S2S_BOS,
                               end_token=S2S_EOS, beam_size=beam,
                               embedding_fn=model.tgt_emb,
                               output_fn=model.out)
    return nn.dynamic_decode(dec, inits=model.encode(src),
                             max_step_num=max_steps)


def seq2seq_rescore(np, paddle, model, src, ids):
    """The teacher-forced score of every beam of ids [b, T, W] (word ids
    from a decode) under `model` (either package): the sum of
    log-softmax(model(src, [S2S_BOS, seq[:, :-1]])) at the beam's tokens
    up to and including its first S2S_EOS, as beam search sums them (a
    finished beam adds nothing more). float64 numpy [b, W]."""
    ids = np.asarray(ids)
    b = ids.shape[0]
    out = []
    for w in range(ids.shape[2]):
        seq = ids[:, :, w]
        tin = np.concatenate([np.full((b, 1), S2S_BOS, np.int64),
                              seq[:, :-1]], 1)
        logits = np.asarray(model(src, paddle.to_tensor(tin)).numpy(),
                            np.float64)
        mx = logits.max(-1, keepdims=True)
        logp = logits - mx - np.log(np.exp(logits - mx).sum(-1,
                                                            keepdims=True))
        picked = np.take_along_axis(logp, seq[..., None], -1)[..., 0]
        end = seq == S2S_EOS
        live = (np.cumsum(end, 1) - end) == 0
        out.append((picked * live).sum(1))
    return np.stack(out, 1)


def decode_agreement(np, ids, scores, ref_ids, ref_scores, rescored,
                     ref_rescored, rtol=S2S_RTOL, factor=S2S_TIE_FACTOR):
    """Card decode (ids [b, T, W], scores [b, W]) against the CPU's (ref_
    ids, ref_scores), with every beam of each side re-scored on the CPU
    by seq2seq_rescore (rescored, ref_rescored [b, W]).
    - max_score_rel: the largest relative score difference, all beams;
      gap: the largest absolute one (nats), the two devices'
      disagreement.
    - near_ties: the sentences whose CPU best beam leads the next by at
      most tie = factor * gap nats (an order the two devices' sums, or
      their pruning of candidates as close, may flip); checked, the
      others; ids_differ, those of them whose best ids differ.
    - rescore_off: the sentences with a card beam whose ids re-score off
      the card's own score for that beam by more than rescore_tol =
      factor * (gap + rescore_noise), rescore_noise the CPU's own
      largest |re-score - score| (ids that are not the sequence the
      score belongs to, as a wrong parent gather or gather_tree would
      give). It holds every beam of every sentence, near-ties
      included."""
    diff = np.abs(scores - ref_scores)
    rel = float(np.max(diff / np.maximum(np.abs(ref_scores), 1e-30)))
    gap = float(diff.max())
    same_len = ids.shape == ref_ids.shape
    equal = np.array([bool(same_len and np.array_equal(ids[i, :, 0],
                                                        ref_ids[i, :, 0]))
                      for i in range(ref_ids.shape[0])])
    rescore_noise = float(np.max(np.abs(ref_rescored - ref_scores)))
    tie = factor * gap
    rescore_tol = factor * (gap + rescore_noise)
    margin = ref_scores[:, 0] - ref_scores[:, 1]
    ties = margin <= tie
    off = np.abs(rescored - scores).max(1)
    return dict(max_score_rel=rel, gap=gap, rescore_noise=rescore_noise,
                tie_factor=factor, tie=tie, near_ties=int(ties.sum()),
                checked=int((~ties).sum()),
                ids_differ=[int(i) for i in np.nonzero(~ties & ~equal)[0]],
                rescore_tol=rescore_tol, rescore_max_off=float(off.max()),
                rescore_off=[int(i) for i in np.nonzero(
                    ~(off <= rescore_tol))[0]],
                rescored_beams=int(rescored.size),
                differ_margins=[float(m) for m in margin[~equal]],
                margin_quantiles=[float(q) for q in np.quantile(
                    margin, (0.0, 0.25, 0.5, 0.75, 1.0))],
                same_steps=same_len, best_ids_equal=int(equal.sum()),
                sentences=int(ref_ids.shape[0]))


def rnn_seq2seq_gates(row):
    """The rnn_seq2seq phase's failures, each a message (empty: ok)."""
    bad = []
    if not all(math.isfinite(v) for v in row["train_losses"]):
        bad.append(f"non-finite losses {row['train_losses']}")
    cpu = row["card_vs_cpu"]
    if not cpu["max_rel"] <= S2S_RTOL:
        bad.append(f"card and CPU training losses differ: {cpu}")
    dec = row["decode_vs_cpu"]
    if not dec["max_score_rel"] <= S2S_RTOL:
        bad.append(f"card and CPU beam scores differ: {dec}")
    if dec["ids_differ"]:
        bad.append(f"beam ids differ beyond the near-ties: {dec}")
    if dec["rescore_off"]:
        bad.append(f"best ids re-score off their beam score: {dec}")
    if not 0 < row["decode_steps"] <= S2S_MAX_STEPS:
        bad.append(f"decode ran {row['decode_steps']} steps")
    return bad


def rnn_seq2seq_phase(torch, pt):
    """The LSTM seq2seq (S2S) on the card, eager. Training: S2S_STEPS
    teacher-forced steps at dropout 0.2 (ms a step, losses finite); then
    card against CPU at dropout 0 from the same weights and batch
    (S2S_STEPS steps each, losses within S2S_RTOL). Decoding: beam_decode
    (beam S2S_BEAM, at most S2S_MAX_STEPS steps, early exit once every
    beam has finished) of the 64 source sentences on the card and on
    the CPU from the same weights (the card's, after its training):
    ms a decoded batch, the steps taken, the scores within S2S_RTOL, the
    best beams' ids equal beyond the near-ties, and every card beam's
    ids re-scored on the CPU to its own score (decode_agreement).
    The path launches none of the port's own kernels."""
    import numpy as np
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import nms
    t0 = time.perf_counter()
    _zero(fa)
    nms.launches["nms_greedy"] = 0
    arrays = seq2seq_batch(np, S2S_BATCH, S2S_LEN, S2S_LEN,
                           S2S["src_vocab"], S2S["tgt_vocab"])
    card_batch = [torch.from_numpy(a).cuda() for a in arrays]
    cpu_batch = [torch.from_numpy(a) for a in arrays]
    pt.seed(SEED)
    model = seq2seq_model(pt, **S2S)
    params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_losses = seq2seq_train(pt, model, card_batch, S2S_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / S2S_STEPS * 1e3
    # card against CPU, dropout 0, the same weights
    f32 = dict(S2S, dropout=0.0)
    pt.seed(SEED)
    card = seq2seq_model(pt, **f32)
    with _OnCpu():
        cpu = seq2seq_model(pt, **f32)
        cpu.set_state_dict({k: v.detach().cpu() for k, v in
                            card.state_dict().items()})
        lc = seq2seq_train(pt, cpu, cpu_batch, S2S_STEPS)
    lg = seq2seq_train(pt, card, card_batch, S2S_STEPS)
    rel = [_rel_diff(a, c) for a, c in zip(lg, lc)]
    # decoding, from the card's trained weights on both
    model.eval()
    with _OnCpu(), torch.no_grad():
        ref = seq2seq_model(pt, **S2S).eval()
        ref.set_state_dict({k: v.detach().cpu() for k, v in
                            model.state_dict().items()})
        rid, rsc = beam_decode(pt, ref, cpu_batch[0])
    with torch.no_grad():
        beam_decode(pt, model, card_batch[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ids, sc = beam_decode(pt, model, card_batch[0])
        torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t2) * 1e3
    ids, sc = ids.cpu().numpy(), sc.cpu().numpy()
    with _OnCpu(), torch.no_grad():
        rescored, ref_rescored = (
            seq2seq_rescore(np, pt, ref, cpu_batch[0], beams)
            for beams in (ids, rid.numpy()))
    agree = decode_agreement(np, ids, sc, rid.numpy(), rsc.numpy(),
                             rescored, ref_rescored)
    launches = dict(fa.launches, **nms.launches)
    row = dict(card=nvidia_smi(), model="LSTM seq2seq", config=S2S,
               params=params, batch=S2S_BATCH, src_len=S2S_LEN,
               tgt_len=S2S_LEN, dtype="float32",
               optimizer=f"Adam({S2S_LR}), ClipGradByGlobalNorm({S2S_CLIP})",
               train_losses=train_losses, step_ms=step_ms,
               card_vs_cpu=dict(dropout=0.0, losses_card=lg, losses_cpu=lc,
                                loss_rel_diff=rel, max_rel=max(rel),
                                rtol=S2S_RTOL),
               beam=S2S_BEAM, max_step_num=S2S_MAX_STEPS,
               decode_steps=int(ids.shape[1]), decode_ms=decode_ms,
               decode_ms_per_step=decode_ms / int(ids.shape[1]),
               decoded_tokens_per_s=S2S_BATCH * int(ids.shape[1])
               / (decode_ms / 1e3),
               decode_vs_cpu=agree, custom_kernel_launches=launches,
               seconds=time.perf_counter() - t0)
    emit({"rnn_seq2seq": row})
    bad = rnn_seq2seq_gates(row)
    if any(launches.values()):
        bad.append(f"the seq2seq path launched the port's kernels: "
                   f"{launches}")
    if bad:
        fail("rnn_seq2seq: " + "; ".join(bad))
    return row


# -- paddle.text and the op library's second half: the CoNLL-2005 SRL -----

# PaddlePaddle's semantic-role labeller, the book's chapter 07
# (label_semantic_roles, a tests/book model of the Fluid era): a db-LSTM
# over CoNLL-2005 with a linear-chain CRF, at the book's widths. Eight
# embeddings (the word and its five context words share one [44,068 x
# 32] table, the predicate a [3,162 x 32] one, the mark a [2 x 5] one),
# hidden_0 the sum of eight fc(., 512, tanh), then 8 LSTMs of 128 units
# on 512-wide gate projections (dynamic_lstm(size=512)), alternating in
# direction, each after the first fed fc(mix) + fc(lstm); feature_out
# the sum of two fc(., 9, tanh), the loss the mean of linear_chain_crf
# (the transition [11, 9], trained at 1e-3 times the rate as the book's
# crfw), decoded by viterbi_decode. SGD at 0.01 (the book's decay, x0.5
# every 100,000 steps, does not fire within an epoch), batch 10, the
# synthetic train split (paddle.text.Conll05st: 512 sentences of 30
# tokens, 9 labels). Stated differences from the book: ops.lstm's
# standard activations (sigmoid gates, tanh candidate and cell) where
# dynamic_lstm had a relu candidate and a sigmoid cell; dense embeddings
# (not is_sparse); the word table trained from random weights (no
# pretrained emb in the repository).
SRL = dict(word_dict_len=44068, pred_dict_len=3162, mark_dict_len=2,
           label_dict_len=9, word_dim=32, mark_dim=5, hidden_dim=512,
           depth=8)
SRL_BATCH, SRL_LR, SRL_CRF_LR = 10, 0.01, 1e-3
SRL_TIMED = 20
SRL_CPU_STEPS, SRL_CPU_RTOL = 4, 1e-4
# a Viterbi score's re-score on the CPU (float64) against the card's
# score, relative
SRL_RESCORE_RTOL = 1e-4
# a path may differ from the CPU's only where the CPU's top-two margin is
# within this many times the two devices' largest score difference
SRL_TIE_FACTOR = 10
SRL_LOSS_WINDOW = 10
# the CPU tests' tiny model: the synthetic split's id ranges (words below
# 1,000, predicates below 100)
SRL_TINY = dict(word_dict_len=1000, pred_dict_len=100, mark_dict_len=2,
                label_dict_len=9, word_dim=8, mark_dim=5, hidden_dim=32,
                depth=2)


def srl_model(paddle, word_dict_len, pred_dict_len, mark_dict_len,
              label_dict_len, word_dim, mark_dim, hidden_dim, depth):
    """The book's db-LSTM + CRF written against the public API of
    `paddle` (either package). forward(word, ctx_n2, ctx_n1, ctx_0,
    ctx_p1, ctx_p2, predicate, mark, length) -> (feature_out [b, t,
    labels], transition [labels + 2, labels]).

    Each LSTM is dynamic_lstm's recurrence over input already projected
    to the gate width: ops.rnn_ops.lstm with an identity input weight,
    so the gates are x_t + h W_hh^T + b. The book trains crfw at
    ParamAttr(learning_rate=1e-3); neither package's optimizers read a
    parameter's learning rate, so the transition is crfw = a u with a =
    sqrt(SRL_CRF_LR), which under SGD moves crfw at exactly SRL_CRF_LR
    times the rate."""
    nn = paddle.nn
    lstm = paddle.ops.rnn_ops.lstm
    gates = hidden_dim
    units = hidden_dim // 4
    scale = math.sqrt(SRL_CRF_LR)

    class GateLSTM(nn.Layer):
        def __init__(self, reverse):
            super().__init__()
            self.weight_hh = self.create_parameter([gates, units])
            self.bias = self.create_parameter([gates], is_bias=True)
            self.reverse = reverse

        def forward(self, x, length):
            out, _, _ = lstm(x, paddle.eye(gates), self.weight_hh,
                             self.bias, paddle.zeros([gates]),
                             sequence_length=length,
                             is_reverse=self.reverse)
            return out

    class DbLstmSRL(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_emb = nn.Embedding(word_dict_len, word_dim)
            self.pred_emb = nn.Embedding(pred_dict_len, word_dim)
            self.mark_emb = nn.Embedding(mark_dict_len, mark_dim)
            self.emb_fc = nn.LayerList(
                [nn.Linear(word_dim, hidden_dim) for _ in range(7)]
                + [nn.Linear(mark_dim, hidden_dim)])
            self.lstms = nn.LayerList([GateLSTM(i % 2 == 1)
                                       for i in range(depth)])
            self.mix_fc = nn.LayerList([nn.Linear(hidden_dim, hidden_dim)
                                        for _ in range(depth - 1)])
            self.lstm_fc = nn.LayerList([nn.Linear(units, hidden_dim)
                                         for _ in range(depth - 1)])
            self.out_mix = nn.Linear(hidden_dim, label_dict_len)
            self.out_lstm = nn.Linear(units, label_dict_len)
            self.crfw = self.create_parameter(
                [label_dict_len + 2, label_dict_len])

        def forward(self, word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
                    predicate, mark, length):
            embs = [self.word_emb(x) for x in (word, ctx_n2, ctx_n1,
                                               ctx_0, ctx_p1, ctx_p2)]
            embs += [self.pred_emb(predicate), self.mark_emb(mark)]
            hidden = None
            for fc, e in zip(self.emb_fc, embs):
                h = paddle.tanh(fc(e))
                hidden = h if hidden is None else hidden + h
            mix, out = hidden, self.lstms[0](hidden, length)
            for i in range(1, depth):
                mix = paddle.tanh(self.mix_fc[i - 1](mix)) + \
                    paddle.tanh(self.lstm_fc[i - 1](out))
                out = self.lstms[i](mix, length)
            feature = paddle.tanh(self.out_mix(mix)) + \
                paddle.tanh(self.out_lstm(out))
            return feature, self.crfw * scale

    return DbLstmSRL()


def srl_param_count(word_dict_len, pred_dict_len, mark_dict_len,
                    label_dict_len, word_dim, mark_dim, hidden_dim, depth):
    """srl_model's parameters, from the widths: the three tables, the
    eight input fcs, `depth` LSTMs (recurrent [gates, units] and a gate
    bias), depth - 1 pairs of mixing fcs, the two output fcs and crfw."""
    h, u, lab = hidden_dim, hidden_dim // 4, label_dict_len
    return (word_dict_len * word_dim + pred_dict_len * word_dim
            + mark_dict_len * mark_dim + 7 * (word_dim * h + h)
            + (mark_dim * h + h) + depth * (h * u + h)
            + (depth - 1) * ((h * h + h) + (u * h + h))
            + (h * lab + lab) + (u * lab + lab) + (lab + 2) * lab)


def srl_loss(paddle):
    """loss((feature, transition), label, length): the mean of
    linear_chain_crf's nll over the batch."""
    def loss(out, label, length):
        feature, transition = out
        return paddle.mean(paddle.linear_chain_crf(feature, transition,
                                                   label, length))
    return loss


def srl_arrays(np, dataset):
    """The dataset's nine fields stacked, each [n, 30] int64, and the
    lengths [n] (every synthetic sentence is MAX_LEN long)."""
    fields = [np.stack([np.asarray(item[k]) for item in dataset]).astype(
        np.int64) for k in range(9)]
    n, t = fields[0].shape
    return fields, np.full((n,), t, np.int64)


def srl_batch(fields, lengths, lo, hi, make):
    """(inputs, labels) of items [lo, hi) for TrainStep, through make (a
    numpy array -> tensor): inputs the eight id fields and the lengths,
    labels the label ids and the lengths."""
    length = make(lengths[lo:hi])
    x = tuple(make(f[lo:hi]) for f in fields[:8]) + (length,)
    return x, (make(fields[8][lo:hi]), length)


def srl_path_score(np, em, trans, path, n):
    """A tag path's CRF score, float64: start, emissions, pairwise and
    stop scores over its first n tags."""
    start, stop, pair = trans[0], trans[1], trans[2:]
    p = np.asarray(path[:n])
    return float(start[p[0]] + em[np.arange(n), p].sum()
                 + pair[p[:-1], p[1:]].sum() + stop[p[-1]])


def viterbi_top2(np, em, trans, n):
    """(best, second best) path scores of one sentence's first n tags,
    float64: a 2-best Viterbi (each tag keeps its two best distinct
    partial paths)."""
    start, stop, pair = trans[0], trans[1], trans[2:]
    k = em.shape[1]
    top = np.full((k, 2), -np.inf)
    top[:, 0] = start + em[0]
    for t in range(1, n):
        cand = (top[:, None, :] + pair[:, :, None]).transpose(1, 0, 2)
        cand = np.sort(cand.reshape(k, -1), axis=1)[:, ::-1][:, :2]
        top = cand + em[t][:, None]
    final = np.sort((top + stop[:, None]).ravel())[::-1]
    return float(final[0]), float(final[1])


def srl_decode_agreement(np, card, cpu, trans_cpu, em_cpu, lengths,
                         rtol=SRL_RESCORE_RTOL, factor=SRL_TIE_FACTOR):
    """Card Viterbi (scores, paths) against the CPU's on the same
    weights: every card path re-scored on the CPU's emission and
    transition in float64 must equal the card's score within rtol; a
    sentence's paths may differ only where the CPU's top-two margin
    (viterbi_top2) is within factor times the largest card-CPU score
    difference (the gap)."""
    scores, paths = card
    ref_scores, ref_paths = cpu
    gap = float(np.abs(scores - ref_scores).max())
    rescored = np.array([srl_path_score(np, em_cpu[i], trans_cpu, paths[i],
                                        int(lengths[i]))
                         for i in range(len(scores))])
    rel = np.abs(rescored - scores) / np.maximum(np.abs(scores), 1.0)
    margins = np.array([np.subtract(*viterbi_top2(np, em_cpu[i], trans_cpu,
                                                  int(lengths[i])))
                        for i in range(len(scores))])
    differ = np.array([not np.array_equal(paths[i], ref_paths[i])
                       for i in range(len(scores))])
    tie = factor * gap
    return dict(sentences=len(scores), gap=gap, rescore_max_rel=float(
        rel.max()), rescore_rtol=rtol,
        rescore_off=[int(i) for i in np.nonzero(~(rel <= rtol))[0]],
        tie_factor=factor, tie=tie, near_ties=int((margins <= tie).sum()),
        paths_differ=[int(i) for i in np.nonzero(differ)[0]],
        differ_outside_ties=[int(i) for i in np.nonzero(
            differ & (margins > tie))[0]],
        margin_quantiles=[float(q) for q in np.quantile(
            margins, (0.0, 0.25, 0.5, 0.75, 1.0))])


def srl_train_gates(row):
    """The srl_train phase's failures, each a message (empty: ok)."""
    bad = []
    cap = row["captured_vs_eager"]
    if not (cap["losses_bit_equal"] and cap["params_bit_equal"]):
        bad.append("the replays are not bit-equal to the eager steps "
                   f"(params max abs diff {cap['params_max_abs_diff']})")
    if row["graphs"] != 1 or row["sentinel_events"] != 0:
        bad.append(f"{row['graphs']} graphs and {row['sentinel_events']} "
                   "sentinel events for one signature")
    if row["params"] != row["params_book"]:
        bad.append(f"{row['params']} parameters, the book's widths give "
                   f"{row['params_book']}")
    if not all(math.isfinite(v) for v in cap["graph_losses"]):
        bad.append("non-finite losses")
    cpu = row["card_vs_cpu"]
    if not cpu["max_rel"] <= SRL_CPU_RTOL:
        bad.append(f"card and CPU losses differ: {cpu}")
    dec = row["decode_vs_cpu"]
    if dec["rescore_off"]:
        bad.append(f"Viterbi scores off their paths' CRF re-score: {dec}")
    if dec["differ_outside_ties"]:
        bad.append(f"paths differ from the CPU's outside near-ties: {dec}")
    if not row["loss_last_window"] < row["loss_first_window"]:
        bad.append(f"the loss did not fall: first {row['loss_first_window']}"
                   f", last {row['loss_last_window']}")
    if any(row["custom_kernel_launches"].values()):
        bad.append(f"the SRL path launched the port's kernels: "
                   f"{row['custom_kernel_launches']}")
    return bad


def _srl_step(pt, cfg):
    """(model, TrainStep) of srl_model at cfg on the current device,
    weights from SEED: SGD(SRL_LR) over every parameter, f32."""
    from paddle_tpu_torch.static import TrainStep
    pt.seed(SEED)
    model = srl_model(pt, **cfg)
    opt = pt.optimizer.SGD(learning_rate=SRL_LR,
                           parameters=model.parameters())
    return model, TrainStep(model, srl_loss(pt), opt)


def srl_train_phase(torch, pt, fa, nms):
    """The CoNLL-2005 SRL db-LSTM + CRF (SRL) trained one epoch of the
    synthetic train split (51 full batches of SRL_BATCH) through the
    captured TrainStep in f32, then the same steps eagerly from the same
    weights: every loss and the trained parameters bit-equal. The card
    against the CPU on the first SRL_CPU_STEPS losses (SRL_CPU_RTOL
    relative). Then SRL_TIMED replays on a synchronised host clock (ms a
    step, tokens/s), the device ms of a replay by category and the idle
    share (profile_step), and the 64 test sentences Viterbi-decoded in
    batches of SRL_BATCH on the card (ms a batch, token accuracy),
    against the CPU's decode on the same weights
    (srl_decode_agreement). The loss's last SRL_LOSS_WINDOW steps must
    average below its first."""
    import numpy as np
    t0 = time.perf_counter()
    train = pt.text.Conll05st(mode="train")
    test = pt.text.Conll05st(mode="test")
    fields, lengths = srl_arrays(np, train)
    steps = len(lengths) // SRL_BATCH

    def card(a):
        return torch.from_numpy(a).cuda()

    batches = [srl_batch(fields, lengths, i * SRL_BATCH,
                         (i + 1) * SRL_BATCH, card) for i in range(steps)]
    model, step = _srl_step(pt, SRL)
    s0 = _to_cpu(step.state_dict())
    _zero(fa)
    nms.launches["nms_greedy"] = 0
    graph_losses = [float(step(x, y)) for x, y in batches]
    graph_params = _snapshot(step)
    step.set_state_dict(s0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eager_losses = [float(step.eager_step(x, y)) for x, y in batches]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) / steps * 1e3
    eager_params = _snapshot(step)
    cap = dict(steps=steps, graph_losses=graph_losses,
               eager_losses=eager_losses,
               losses_bit_equal=graph_losses == eager_losses,
               params_bit_equal=_bit_equal(graph_params, eager_params),
               params_max_abs_diff=_max_abs_diff(graph_params, eager_params))
    del graph_params, eager_params
    launches = dict(fa.launches, **nms.launches)
    x, y = batches[0]
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(SRL_TIMED):
        step(*batches[i % steps])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    prof = profile_step(torch, step, x, y)
    step_ms = secs / SRL_TIMED * 1e3
    tokens = SRL_BATCH * fields[0].shape[1]
    # decode the test split on the card, in batches of SRL_BATCH
    tf, tl = srl_arrays(np, test)
    model.eval()
    paths, scores, ems = [], [], []
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        for lo in range(0, len(tl), SRL_BATCH):
            xb, _ = srl_batch(tf, tl, lo, lo + SRL_BATCH, card)
            em, trans = model(*xb)
            sc, pa = pt.viterbi_decode(em, trans, xb[-1])
            paths.append(pa)
            scores.append(sc)
            ems.append(em)
        torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t2) * 1e3 / len(paths)
    paths = torch.cat(paths).cpu().numpy()
    scores = torch.cat(scores).double().cpu().numpy()
    acc = float((paths == tf[8]).mean())
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    graphs, sentinel = step.programs, step.recompile_sentinel.fired
    step.release()
    del step, batches
    torch.cuda.empty_cache()
    # the CPU: the first steps from s0, and the decode on the trained
    # weights
    with _OnCpu():
        cpu_model, cpu_step = _srl_step(pt, SRL)
        cpu_step.set_state_dict(s0)
        cpu_losses = [float(cpu_step.eager_step(*srl_batch(
            fields, lengths, i * SRL_BATCH, (i + 1) * SRL_BATCH,
            torch.from_numpy))) for i in range(SRL_CPU_STEPS)]
        cpu_model.set_state_dict(trained)
        cpu_model.eval()
        with torch.no_grad():
            xc, _ = srl_batch(tf, tl, 0, len(tl), torch.from_numpy)
            em_cpu, trans_cpu = cpu_model(*xc)
            ref_scores, ref_paths = pt.viterbi_decode(em_cpu, trans_cpu,
                                                      xc[-1])
    rel = [_rel_diff(a, c) for a, c in
           zip(graph_losses[:SRL_CPU_STEPS], cpu_losses)]
    agree = srl_decode_agreement(
        np, (scores, paths), (ref_scores.double().numpy(),
                              ref_paths.numpy()),
        trans_cpu.double().numpy(), em_cpu.double().numpy(), tl)
    first = sum(graph_losses[:SRL_LOSS_WINDOW]) / SRL_LOSS_WINDOW
    last = sum(graph_losses[-SRL_LOSS_WINDOW:]) / SRL_LOSS_WINDOW
    row = dict(card=nvidia_smi(), model="db-LSTM + CRF (book ch. 07)",
               config=SRL, dataset="paddle.text.Conll05st synthetic",
               train_sentences=len(lengths), test_sentences=len(tl),
               batch=SRL_BATCH, seq_len=int(fields[0].shape[1]),
               dtype="float32", optimizer=f"SGD({SRL_LR}), crfw at "
               f"{SRL_CRF_LR}x", params=sum(p.numel() for p in
                                            model.parameters()),
               params_book=srl_param_count(**SRL),
               captured_vs_eager=cap, graphs=graphs,
               sentinel_events=sentinel, loss_first_window=first, loss_last_window=last,
               step_ms=step_ms, eager_step_ms=eager_ms,
               tokens_per_s=tokens / (step_ms / 1e3),
               eager_tokens_per_s=tokens / (eager_ms / 1e3),
               device_ms_per_step=prof["device_ms"],
               idle_share=max(0.0, 1.0 - prof["device_ms"] / step_ms),
               kernel_launches_per_replay=prof["events"],
               profile=_profile_row(prof, top=12),
               decode_ms_per_batch=decode_ms, decode_batches=len(
                   range(0, len(tl), SRL_BATCH)),
               token_accuracy=acc,
               card_vs_cpu=dict(steps=SRL_CPU_STEPS,
                                losses_card=graph_losses[:SRL_CPU_STEPS],
                                losses_cpu=cpu_losses, loss_rel_diff=rel,
                                max_rel=max(rel), rtol=SRL_CPU_RTOL),
               decode_vs_cpu=agree, custom_kernel_launches=launches,
               seconds=time.perf_counter() - t0)
    emit({"srl_train": row})
    bad = srl_train_gates(row)
    if bad:
        fail("srl_train: " + "; ".join(bad))
    return row


def philox_phase(torch, build):
    """(instructions per Philox4x32-10 call, SMs, max SM clock MHz): the
    call's instructions counted in the SASS of the head_dim-64 dropout
    forward (fwd_wgmma<64, non-causal, dropout>), its keep-bit loop.
    None for a tree without that kernel (this script run against an
    older tree's kernels, to compare the two on one card)."""
    lib = str(build.library_path("flash_attn_fwd"))
    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs = sass_functions(text)
    name = next((f for f in funcs if "fwd_wgmma" in f
                 and "ILi64ELb0ELb1E" in f), None)
    if name is None:
        emit({"philox_sass": None})
        return None
    loop = philox_loop(funcs[name])
    if loop is None:
        fail(f"no Philox keep-bit loop in the SASS of {name}")
    ipc, calls, body = loop
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"philox_sass": dict(
        function=name, loop_instructions=body, calls_in_loop=calls,
        instructions_per_call=ipc, sms=sms, max_sm_clock_mhz=clock,
        int_ops_per_clock_sm=INT_OPS_PER_CLOCK_SM,
        int_rate_source="CUDA C++ Programming Guide, arithmetic "
                        "instruction throughput, compute capability 9.0")})
    return ipc, sms, clock


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not os.path.isfile(os.path.join(REPO, "paddle_tpu_torch",
                                       "__init__.py")):
        fail(f"no paddle_tpu_torch package beside {__file__}: run it from "
             "the root of a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import nms

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln or "warning" in ln.lower()
                 or "Performance" in ln]
        emit({"build": name, "seconds": info["seconds"],
              "cached": info["cached"], "ptxas": ptxas})
        spilled = [f for f, st, ld in ptxas_spills(info["log"])
                   if any(k in f for k in NO_SPILL) and "ILi64E" in f
                   and (st or ld)]
        if spilled:
            fail(f"ptxas spills in a head_dim-64 wgmma kernel: {spilled}")
        serial = [f for f in ptxas_serialised(info["log"])
                  if any(k in f for k in NO_SPILL) and "ILi64E" in f]
        if serial:
            fail(f"ptxas serialises the wgmma of a head_dim-64 kernel: "
                 f"{serial}")
        ffma = ffma_ptxas_failure(name, info["log"])
        if ffma:
            fail(ffma)
        for src, want, what in ((WG256_SOURCE, WG256_INSTANTIATIONS,
                                 "head_dim-256 wgmma"),
                                (WIDE_SOURCE, WIDE_INSTANTIATIONS,
                                 "f32 FFMA from head_dim 256"),
                                (WGWIDE_SOURCE, WGWIDE_INSTANTIATIONS,
                                 "head_dim above 256 wgmma"),
                                (GRAPH_WHILE_SOURCE, 1, "graph_while")):
            if name != src:
                continue
            spills = ptxas_spills(info["log"])
            spilling = [f for f, st, ld in spills if st or ld]
            if len(spills) != want or spilling:
                fail(f"ptxas: {len(spills)} {what} kernels reported "
                     f"(want {want}), spilling: {spilling}")
            if (src in (WG256_SOURCE, WGWIDE_SOURCE)
                    and ptxas_serialised(info["log"])):
                fail(f"ptxas serialises the wgmma of a {what} kernel: "
                     f"{ptxas_serialised(info['log'])}")
    emit({"build_seconds": build_s})
    philox = philox_phase(torch, _build)

    clock = _PhaseClock()
    cases = kernel_phase(torch, fa)
    bwd_cases = bwd_kernel_phase(torch, fa, philox)
    clock.step("kernel_and_bwd_kernel")
    probes = mask_probe_phase(torch, fa)
    pad_cases = head_pad_phase(torch, fa)
    clock.step("mask_probe_and_head_pad")
    d256_cases = d256_kernel_phase(torch, fa)
    d256_probes = d256_mask_probe_phase(torch, fa)
    clock.step("d256_kernel")
    enc256 = encoder_256_phase(torch, pt, fa)
    enc256_f32 = encoder_256_phase(torch, pt, fa, "encoder_256_f32")
    clock.lap("head_dim_256")
    wide_cases = wide_kernel_phase(torch, fa)
    wide_probes = wide_mask_probe_phase(torch, fa)
    clock.step("wide_kernel")
    wide_hard = wide_hard_phase(torch, fa)
    sdpa_routes = sdpa_f32_routes_phase(torch)
    clock.step("wide_hard_and_sdpa_routes")
    encwide = encoder_256_phase(torch, pt, fa, "encoder_wide")
    encwide_f32 = encoder_256_phase(torch, pt, fa, "encoder_wide_f32")
    clock.lap("head_dim_wide")
    graph_while = graph_while_phase(torch, pt)
    static_while = to_static_while_phase(torch, pt)
    clock.lap("graph_while")
    host_cost_phase(torch, fa)
    nms_cases = nms_kernel_phase(torch, nms)
    _zero(fa)
    clock.lap("kernel_cases")
    rows, launches_inf, launches_f32 = main_path(torch, pt, fa)
    clock.step("main_path")
    train = train_path(torch, pt, fa)
    clock.step("train_path")
    torch.cuda.empty_cache()
    train_cpu_check(torch, pt, fa)
    clock.lap("ernie_paths")
    gpt_rows, gpt_cases, gpt_model, gpt_launches = gpt_forward_phase(
        torch, pt, fa)
    clock.step("gpt_forward")
    generate_phase(torch, pt, fa, gpt_model)
    clock.step("generate")
    serving_row, bf16_streams = serving_phase(torch, pt, fa, gpt_model)
    clock.step("serving")
    parity = serving_parity_phase(torch, pt, fa, gpt_model)
    clock.step("serving_parity")
    serving_levers_phase(torch, pt, fa, gpt_model, bf16_streams, parity)
    clock.step("serving_levers")
    generate_capture_phase(torch, pt, gpt_model)
    clock.step("generate_capture")
    telemetry_phase(torch, pt, gpt_model)
    clock.step("telemetry")
    torch.cuda.empty_cache()
    fleet_phase(torch, pt, gpt_model, serving_row, parity)
    clock.step("fleet")
    loadgen_phase(torch, pt, gpt_model)
    clock.lap("gpt_serving")
    del gpt_model, parity
    torch.cuda.empty_cache()
    gpt_kernel_rows, gpt_probes = gpt_train_kernels_phase(torch, fa, philox)
    gpt_train = gpt_train_path(torch, pt, fa)
    clock.step("gpt_train")
    torch.cuda.empty_cache()
    dense = {"ernie": train, "gpt": gpt_train}
    _, chunked = chunked_ce_phase(torch, pt, fa, dense)
    clock.step("chunked_ce")
    scanned = scan_layers_phase(torch, pt, fa, dense)
    clock.lap("gpt_training")
    ernie_determinism_phase(torch, pt)
    clock.step("ernie_determinism")
    captured = {}
    for kind in ("ernie", "gpt"):
        captured[kind], model, step, x, _ = captured_train_phase(
            torch, pt, fa, kind)
        if kind == "gpt":
            captured_eval_phase(torch, step, x)
        step.release()
        del model, step, x
        torch.cuda.empty_cache()
    clock.step("captured_train")
    # ERNIE-base's step in f32 (no AMP): the f32 forward, dQ and dK/dV at
    # head_dim 64, 12 of each a replay
    captured_f32, model, step, _, _ = captured_train_phase(
        torch, pt, fa, "ernie", key="captured_train_f32", amp_level=None,
        routes=F32_TRAIN_ROUTES)
    step.release()
    del model, step
    torch.cuda.empty_cache()
    clock.lap("captured_training_f32")
    static_train = static_train_phase(torch, pt, fa, captured_f32)
    torch.cuda.empty_cache()
    clock.lap("static_train")
    scaler = captured_scaler_phase(torch, pt, fa)
    clock.step("captured_scaler")
    remat = {kind: remat_phase(torch, pt, fa, kind)
             for kind in ("gpt", "ernie")}
    clock.step("remat")
    lr_schedule_phase(torch, pt)
    optimizers_phase(torch)
    clock.lap("captured_training")
    sentry, plain = sentry_train_phase(torch, pt, fa)
    clock.lap("sentry_and_anatomy")
    optimizer_extras_phase(torch, pt)
    clock.lap("optimizer_extras")
    dp = dp_train_phase(torch, pt, fa)
    clock.step("dp_train")
    torch.cuda.empty_cache()
    with _OneRankGroup():
        moe = moe_train_phase(torch, pt, fa, captured["ernie"])
        clock.step("moe_train")
        torch.cuda.empty_cache()
        plan_train_phase(torch, pt)
        clock.step("plan_train")
        sp = sp_train_phase(torch, pt, fa)
        clock.step("sp_train")
    torch.cuda.empty_cache()
    pipe_case, pipe_probe = pipe_kernel_phase(torch, fa, philox)
    clock.step("pipe_kernel")
    pipe = pipeline_train_phase(torch, pt, fa, captured["ernie"])
    torch.cuda.empty_cache()
    clock.lap("parallel_training")
    resnet = resnet_train_phase(torch, pt, fa)
    clock.step("resnet_train")
    torch.cuda.empty_cache()
    yolo, yolo_model = yolo_train_phase(torch, pt, fa, nms)
    clock.step("yolo_train")
    yolo_fit_phase(torch, pt, yolo)
    serve = yolo_serve_phase(torch, pt, fa, nms, yolo_model)
    clock.lap("vision")
    predictor = predictor_phase(torch, pt, fa, nms, yolo_model)
    del yolo_model
    torch.cuda.empty_cache()
    clock.lap("predictor")
    ops_card_phase(torch, pt)
    clock.step("ops_card")
    amp_card_phase(torch, pt)
    clock.step("amp_card")
    mnist = mnist_dygraph_phase(torch, pt, fa, nms, smi)
    clock.step("mnist_dygraph")
    torch.cuda.empty_cache()
    mt = transformer_train_phase(torch, pt, fa)
    clock.step("transformer_train")
    torch.cuda.empty_cache()
    rnn_seq2seq_phase(torch, pt)
    clock.step("rnn_seq2seq")
    torch.cuda.empty_cache()
    srl_train_phase(torch, pt, fa, nms)
    torch.cuda.empty_cache()
    clock.lap("ops_and_text_models")
    elastic_train_phase(torch)
    clock.lap("elastic_train")
    emit({"capture_hazards": dict(
        capture_mode="global (torch.cuda.graph's default): every capture "
                     "of this run succeeded, the kernels' host calls "
                     "(sm_count, tensor-map encoding, "
                     "cudaFuncSetAttribute) included; yolo_fit's "
                     "DataLoader makes its CUDA calls on the consumer's "
                     "thread, between steps, never inside a capture",
        tensor_maps="encoded once at capture over the graph pool's "
                    "addresses; held by the graph-vs-eager checks, "
                    "bit-equal: " + ", ".join(captured),
        profiler="torch.profiler sees the kernels inside a replay: every "
                 "captured run's replays were profiled and counted on the "
                 "card")})

    # every row at the training path's shape: b 48, s 512, n 12, h 64,
    # bf16, non-causal, dropout 0.1, strided qkv views
    head = next(c for c in bwd_cases if c["dtype"] == "bfloat16"
                and c["b"] == TRAIN_BATCH[0] and c["s"] == 512
                and not c["causal"] and c["dropout_p"])
    head_p0 = next(c for c in bwd_cases if c["dtype"] == "bfloat16"
                   and c["b"] == TRAIN_BATCH[0] and c["s"] == 512
                   and not c["causal"] and not c["dropout_p"])
    shape = "b48 s512 n12 h64 bfloat16 non-causal dropout 0.1"
    by_path = {k: {"inference": launches_inf if k == "flash_attn_fwd"
                   else 0, "training": train["launches"][k],
                   "gpt_forward": gpt_launches if k == "flash_attn_fwd"
                   else 0, "gpt_training": gpt_train["launches"][k],
                   **{f"chunked_ce_{m}": chunked[m]["launches"][k]
                      for m in chunked},
                   **{f"scan_layers_{m}": scanned[m]["launches"][k]
                      for m in scanned},
                   **{f"captured_training_{m}": captured[m]["launches"][k]
                      for m in captured},
                   "captured_training_ernie_f32":
                       captured_f32["launches"][k],
                   "static_train_executor": static_train["launches"][k],
                   "predictor_ernie": predictor["ernie"]["launches"][k],
                   "captured_training_gpt_scaler_accum2":
                       scaler["launches"][k],
                   **{f"remat_{p}_{m}": remat[m][p]["launches"][k]
                      for m in remat for p in remat[m] if p != "plain"},
                   "dp_training_gpt": dp["launches"][k],
                   "moe_training": moe["launches"][k],
                   "sp_ulysses_per_step":
                       sp["ulysses"]["launches_per_step"][k],
                   "sp_ring_per_step": sp["ring"]["launches_per_step"][k],
                   "pipeline_training": pipe["path_launches"][k],
                   "resnet_training": resnet["flash_launches"][k],
                   "yolo_training": yolo["flash_launches"][k],
                   "yolo_serving": serve["flash_launches"][k],
                   "mnist_dygraph": mnist["custom_kernel_launches"][k],
                   "transformer_training": mt["launches"][k]}
               for k in fa.launches}
    # every row at GPT-2 small's training shape: b 8, s 1024, n 12, h 64,
    # bf16 (the O1 path's attention), causal, dropout 0.1
    gpt_head = next(c for c in gpt_kernel_rows if c["dtype"] == "bfloat16")
    gpt_shape = "b8 s1024 n12 h64 bfloat16 causal dropout 0.1"
    per_step = gpt_train["launches_per_step"]
    gpt_at = _kernels_at(gpt_head, gpt_shape)
    for k, v in gpt_at.items():
        v.update(launches_per_step=per_step[k],
                 launches_per_dp_step=dp["launches_per_replay"][k])
    # at the pipeline's microbatch: b 6, s 512, the rest as `shape`
    pipe_at = _kernels_at(pipe_case, "b6 s512 n12 h64 bfloat16 "
                                     "non-causal dropout 0.1")
    for k, v in pipe_at.items():
        v.update(launches_per_step=pipe["launches_per_step"][k])
    # at Transformer-base's two shapes on the kernels: b 32, n 8, h 64,
    # bf16, dropout 0.1, separate q, k and v; the decoder's
    # cross-attention (sq 96, sk 128) and the encoder's self-attention
    # (sq = sk = 128)
    mt_at = {}
    for what, (sq, sk) in (("cross", MT_SHAPES[1]), ("self", MT_SHAPES[0])):
        row = next(c for c in bwd_cases if c["dtype"] == "bfloat16"
                   and c["s"] == sq and c["sk"] == sk and c["dropout_p"]
                   and c["layout"] == _layout(True))
        mt_at[what] = _kernels_at(row, f"b32 sq{sq} sk{sk} n8 h64 bfloat16 "
                                       "non-causal dropout 0.1, separate "
                                       "q, k and v")
    d256_rows = d256_kernel_rows(d256_cases)
    wide_rows = wide_kernel_rows(wide_cases + wide_hard)
    # no library call computes one backward kernel's outputs alone: the
    # backward rows carry SDPA's backward beside the whole backward
    common = dict(route="cuda", shape=shape)
    whole_bwd = dict(library_ms=None, backward_ms=head["backward_ms"],
                     backward_library_ms=head["backward_library_ms"])
    kernels = [
        dict(name="flash_attn_fwd",
             source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:175",
             max_abs_err=head["o_max_abs_err"], ms=head["fwd_ms"],
             plain_ms=head["fwd_plain_ms"], bound_ms=head["fwd_bound_ms"],
             bound_by=head["fwd_bound_by"],
             library_ms=head["fwd_library_ms"],
             bound_note=head["fwd_bound"]["bound_note"],
             dropout_work={k: head["fwd_bound"].get(k) for k in (
                 "philox_calls", "philox_int_instructions",
                 "philox_floor_ms", "bound_reachable")},
             at_dropout_0=dict(ms=head_p0["fwd_ms"],
                               library_ms=head_p0["fwd_library_ms"],
                               bound_ms=head_p0["fwd_bound_ms"],
                               bound_by=head_p0["fwd_bound_by"]),
             launches_float32_inference_pass=launches_f32,
             gpt_causal=gpt_cases, inference_cases=cases),
        dict(name="flash_attn_bwd_dq",
             source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:283",
             max_abs_err=head["dq_max_abs_err"], ms=head["dq_ms"],
             plain_ms=head["dq_plain_ms"], bound_ms=head["dq_bound_ms"],
             bound_by=head["dq_bound_by"],
             delta_max_abs_err=head["delta_max_abs_err"], **whole_bwd),
        dict(name="flash_attn_bwd_dkv",
             source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:319",
             max_abs_err=max(head["dk_max_abs_err"], head["dv_max_abs_err"]),
             ms=head["dkv_ms"], plain_ms=head["dkv_plain_ms"],
             bound_ms=head["dkv_bound_ms"], bound_by=head["dkv_bound_by"],
             **whole_bwd)]
    for kern in kernels:
        kern.update(common, launches=by_path[kern["name"]]["training"],
                    launches_by_path=by_path[kern["name"]],
                    launches_per_moe_step=moe["launches_per_replay"][
                        kern["name"]],
                    gpt_training=gpt_at[kern["name"]],
                    pipeline_training=pipe_at[kern["name"]])
        if kern["launches"] == 0:
            fail(f"the training path launched no {kern['name']} kernel")
        if by_path[kern["name"]]["moe_training"] == 0:
            fail(f"the MoE training path launched no {kern['name']} "
                 "kernel")
        if by_path[kern["name"]]["pipeline_training"] == 0:
            fail(f"the pipeline training path launched no {kern['name']} "
                 "kernel")
        if by_path[kern["name"]]["transformer_training"] == 0:
            fail(f"the Transformer-base training path launched no "
                 f"{kern['name']} kernel")
        kern["transformer_training"] = dict(
            launches_per_step=mt["launches_per_step"][kern["name"]],
            **mt_at["cross"][kern["name"]],
            self_attention=mt_at["self"][kern["name"]])
        # head_dim 256: the kernel cases' rows at D256_SHAPE and at the
        # encoder_256 phases' attention (each row names its device
        # kernel: bf16 on csrc/flash_attn_wg256.cu, f32 on
        # csrc/flash_attn_wide.cu, a cluster of one); the launches of
        # the encoder_256 paths
        kern["head_dim_256"] = dict(
            sources=["paddle_tpu_torch/csrc/flash_attn_wg256.cu",
                     "paddle_tpu_torch/csrc/flash_attn_wide.cu"],
            shape="b{} s{} n{} h{}, qkv views".format(*D256_SHAPE),
            launches_encoder_256=enc256["launches"][kern["name"]],
            launches_encoder_256_f32=enc256_f32["launches"][kern["name"]],
            cases=d256_rows[kern["name"]])
        # above head_dim 256: the kernel cases at 512 and 1024, at the
        # encoder_wide phases' attention, at WIDE_HARD_CASES and at D
        # 2304 (bf16 on csrc/flash_attn_wgwide.cu, f32 on
        # csrc/flash_attn_wide.cu; 320 runs padded to 512 through the
        # autograd entry: wide_case rows with entry_fwd_bwd_ms); the
        # launches of the encoder_wide paths
        kern["head_dim_wide"] = dict(
            sources=["paddle_tpu_torch/csrc/flash_attn_wgwide.cu",
                     "paddle_tpu_torch/csrc/flash_attn_wide.cu"],
            shape="b{} s{} n{}, h 512 and 1024, qkv views; each case "
                  "row names its shape".format(*WIDE_SHAPE),
            launches_encoder_wide=encwide["launches"][kern["name"]],
            launches_encoder_wide_f32=encwide_f32["launches"][
                kern["name"]],
            cases=wide_rows[kern["name"]])
    if launches_inf == 0:
        fail("the inference path launched no flash_attn_fwd kernel")
    kernels += encoder_kernel_rows(
        {"encoder_256": enc256, "encoder_256_f32": enc256_f32,
         "encoder_wide": encwide, "encoder_wide_f32": encwide_f32},
        d256_cases + wide_cases)
    kernels.append(ffma_fwd_kernel_row(captured_f32, bwd_cases, cases,
                                       launches_f32))
    kernels += ffma_kernel_rows(captured_f32, bwd_cases)
    # the static Executor's ERNIE-base step and the ERNIE-base Predictor
    # run the same f32 kernels: their launches beside the captured step's
    for kern in kernels[-3:]:
        wrapper = kern["name"][:-len("_ffma")]
        kern["launches_by_path"] = dict(
            captured_train_f32=captured_f32["launches"][wrapper],
            static_train_executor=static_train["launches"][wrapper],
            static_train_per_replay=static_train["launches_per_replay"][
                wrapper],
            predictor_ernie=predictor["ernie"]["launches"][wrapper])
    # greedy NMS: no Pallas origin; at the serving path's shape (640
    # problems of K 400 pixel boxes, eta 1.0: multiclass_nms's candidates
    # of a YOLOv3 batch of 8 at 608)
    kernels.append(dict(
        name="nms_greedy", route="cuda",
        source="paddle_tpu_torch/csrc/nms.cu",
        replaces="none: no Pallas kernel (the XLA fori_loop of "
                 "paddle_tpu/ops/detection.py:488 _greedy_nms_mask)",
        launches=serve["launches_per_hard_predict"],
        max_abs_err=float(serve["kernel_vs_plain"]["mismatches"]),
        ms=serve["ms_per_batch"]["nms_kernel"],
        plain_ms=serve["ms_per_batch"]["nms_plain"],
        bound_ms=serve["nms_bound_ms"], bound_by=serve["nms_bound_by"],
        library_ms=None,
        shape=f"{serve['problems']} problems x K {serve['k']}, pixel boxes, "
              "eta 1.0 (YOLOv3 serving, batch 8 at 608)",
        launches_by_path={"yolo_training": yolo["nms_launches"],
                          "yolo_serving": serve["launches_per_hard_predict"],
                          "yolo_predictor_warmup": predictor["yolo"][
                              "nms_launches_warmup"],
                          "yolo_predictor_per_replay": predictor["yolo"][
                              "nms_launches_per_replay"],
                          "mnist_dygraph": mnist["custom_kernel_launches"][
                              "nms_greedy"]},
        cases=nms_cases))
    if serve["launches_per_hard_predict"] == 0:
        fail("the serving path launched no nms_greedy kernel")
    # the captured while_loop's one kernel: set_condition, recorded before
    # the WHILE node and as its body's last kernel; a replay runs it once
    # a trip on the card (no Pallas origin: lax.while_loop's device loop)
    kernels.append(dict(
        name="graph_while_set_condition", route="cuda",
        source="paddle_tpu_torch/csrc/graph_while.cu",
        replaces="none: no Pallas kernel (lax.while_loop of "
                 "paddle_tpu/ops/control_flow.py:61-75)",
        launches=graph_while["set_condition_launches_captured"][
            "graph_while_set_condition"],
        max_abs_err=0.0, ms=graph_while["replay_ms"],
        plain_ms=graph_while["eager_loop_ms"],
        bound_ms=graph_while["bound_ms"],
        bound_by=graph_while["bound_by"], library_ms=None,
        shape="Collatz steps of {} lanes, {} trips a replay".format(
            len(COLLATZ_INPUTS[-1]), graph_while["trips_timed"]),
        launches_by_path={
            "graph_while": graph_while["set_condition_launches_captured"][
                "graph_while_set_condition"],
            "to_static_while": static_while[
                "set_condition_launches_captured"][
                "graph_while_set_condition"]},
        what="ms: one replay of the captured loop (every trip on the "
             "card); plain_ms: the eager loop (a host read a trip)"))
    if not graph_while["set_condition_launches_captured"][
            "graph_while_set_condition"]:
        fail("the captured while_loop recorded no set_condition kernel")
    emit({"kernels": kernels, "philox": "paddle_tpu_torch/csrc/philox.cuh "
          "replaces paddle_tpu/ops/pallas_kernels.py:157 (inside all three)",
          "mask_probes": probes + gpt_probes + [pipe_probe] + d256_probes
          + wide_probes,
          "sdpa_f32_routes": sdpa_routes,
          "phase_seconds": clock.laps, "step_seconds": clock.steps,
          "backward_cases": bwd_cases, "head_pad_cases": pad_cases,
          "gpt_training_cases": gpt_kernel_rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
