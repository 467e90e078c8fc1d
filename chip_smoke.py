#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dcgan_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU (sm_90a) and
nvcc. Needs one card; no network. Phases, each fatal on failure:

1. build: every CUDA kernel of the served and the training path, from
   dcgan_tpu_torch/csrc (nvcc, one process per source, all at once); each
   kernel's registers, stack and spills from ptxas, by entry function
   (the entries of NO_SPILLS must not spill); the redesigned kernels'
   machine code (cuobjdump -sass) must hold the Hopper instructions of
   HOPPER_SASS, whose counts are logged;
2. kernels: each kernel against its plain PyTorch version on the same card
   tensors at the shapes the served path (kernels 2, 5) and the training
   step (kernels 1-4; kernel 2 at every BN epilogue and every act, kernel
   1 also at the epilogue shapes of the use_pallas route) give it
   (celeba64, batch 64), in bf16 and f32, plus ragged shapes (kernels 4
   and 5: an aligned one on the v2 design, an unaligned one on v1, f32 on
   SIMT; kernel 3: the vector design at C 72, the scalar one at C 70 and
   off 16-byte alignment; kernel 2: [37, 70] and bn0 2 elements off
   alignment on its scalar design; kernel 1: (37, 70), (5, 3) and bn0 one
   element off alignment on its scalar design), kernels 1, 3, 4, 5 also
   launched twice to show they repeat bit for bit; the launch plan per
   stage of kernels 4 and 5 (gbsa_plan) and of kernel 1 (moments_plan)
   and the design each launch of kernels 1-5 took are checked and
   logged; then timed with CUDA events (the median of three windows)
   beside its bound, its plain version and a library call, per shape and
   per training step; kernels 1 and 2 also over a ring of copies of their
   input larger than the L2, so that they read from HBM (`hbm_ms`);
3. serve: seeded celeba64 weights (use_pallas + pallas_fused, BN running
   statistics calibrated on a batch and perturbed with numpy noise) are
   written with convert.save_weights and served through
   `python -m dcgan_tpu_torch.serve`'s entry point on cuda, 24 demo
   requests of 1-8 images; the kernels' launch counters are set to 0 just
   before and read just after, and must both have risen, every kernel 5
   launch on its v2 design and every kernel 2 launch on its vector design;
4. outputs: every served image is finite, in [-1, 1], shape [n, 64, 64, 3];
   requests match a direct sampler call on the same z rows; one batch
   matches the cuDNN + torch-BN route (use_pallas=False), in bf16 and, with
   TF32 off, in f32; then one bf16 sampler call at batch 64 is timed on
   both routes;
5. train: `python -m dcgan_tpu_torch.train`'s entry point (train.cli.main,
   --preset celeba64 --use_pallas --pallas_fused --synthetic, batch 64) for
   TRAIN_STEPS steps on cuda, the launch counters set to 0 just before and
   read just after: each kernel must have launched exactly its per-step
   count times the steps, kernels 1-4 always on their designs of
   TRAIN_DESIGN; the losses are finite and every parameter and BN running
   statistic moved from the seeded init;
6. train outputs: the losses and both nets' gradients at the seeded
   state on the kernel route and on the cuDNN + torch-BN route, same
   images and z, within TRAIN_ROUTE_TOL and, leaf by leaf,
   TRAIN_GRAD_TOL in bf16 and (TF32 off) f32; one bf16 step per route
   checked for host-device synchronizations, timed on the host clock, and
   profiled with torch.profiler: device busy time by kernel family, the
   idle share and the costliest kernels.

The sagan64 slice (attention at 32x32 in both nets on the flash kernels,
spectral norm, hinge loss, TTUR, G EMA):

7. flash kernels: the forward, dq and dkv kernels (6-8) against their
   plain versions in bf16 and f32 at sagan64's shape (B 64, S 1024,
   d_qk 8, d_v 32), a ragged S, d_qk 16, S one past a 128-key tile and
   rows that are not 16-byte multiples (the bf16 kernels' scalar loads),
   each launched twice to show the bits repeat; at S 4096 and 16384
   (sagan128's and sagan256-lc's attention) launched at batch 64 and
   compared over a 2-row batch slice; each timed beside its bound (the
   largest of bytes, products and exponentials), its plain version and
   F.scaled_dot_product_attention on the same q, k, v (the backend it
   picked named from its kernels);
8. sagan64 train: `train.cli.main --preset sagan64 --synthetic` for
   TRAIN_STEPS steps, the launch counters set to 0 just before and read
   just after (exactly SAGAN_PER_STEP per step); losses finite; every
   parameter, BN statistic and sn_* vector moved;
9. sagan64 routes: from the seeded state with gamma = 0.5 in both
   attention blocks, the losses and every gradient leaf on the flash
   route against the dense route, within ATTN_ROUTE_TOL in bf16 and f32;
   two broken backwards (dq zeroed; the delta term dropped from dkv) must
   each be caught; one bf16 step profiled (attention share and ms per
   flash kernel, idle share);
10. sagan64 serve: the trained EMA G (its gamma set to 0.5) served through
   the serve entry point with the counters reset around it; the images
   checked as in phase 4 and against the dense route.

celeba64 from TFRecords, checkpointed and resumed:

11. resume: RESUME_RECORDS random 64x64x3 images in the preset's record
   dtype, in RESUME_SHARDS TFRecord shards (the port's
   write_image_tfrecords); the trainer's `train()` (celeba64, batch 64,
   use_pallas and pallas_fused) runs RESUME_FIRST_STEPS steps from them,
   saving after every step and writing a sample grid at the last; its
   newest checkpoint restores equal to the final in-memory state, leaf for
   leaf and bit for bit; a second `train()` on the same directory restores
   it and runs to RESUME_STEPS, events.jsonl continuing; the newest step,
   truncated, becomes `<step>.corrupt` and the restore falls back to the
   step before; the directory is served through the serve entry point
   (`--checkpoint_dir`), RESUME_REQUESTS requests equal to the sampler on
   the restored weights within SERVED_TOL; the launch counters are set to 0
   before the first run and read after the serving (kernels 1, 3 and 4 at
   exactly their per-step counts, 2 and 5 also in the sampler); one train
   step from the restored state and one from the in-memory state on the
   same batch and z agree (bit for bit, or within TRAIN_ROUTE_TOL); the
   grid PNG decodes with zlib, no PIL, to [8 x 64, 8 x 64, 3] and the
   sampler's images of that step; then timed: the checkpoint's bytes, save
   (host copy, write) and restore (verify, read) of the final state, the
   loader's images/s, and the host-inclusive step ms and profiled idle
   share with the TFRecord feed against the synthetic feed, in turns,
   eager and through the captured runner at K = CAPTURE_K.

On the card the trainer's steps (phases 5, 8, 11) run through the
captured runner (train/warmup.py: an eager warm-up step, then CUDA graph
replays, which add the launches their capture recorded to the counters),
and every serve rung (phases 3, 10, 11) is a captured sampler graph: each
served batch is held against the eager sampler on the same z, bit for
bit, and `serve/recompiles_after_warmup` must be 0.

Captured programs (`capture`):

12. capture: from the seeded state, CAPTURE_STEPS steps eager (twice: the
   step must repeat bit for bit) and through `StepRunner` at K = 1 and K
   = CAPTURE_K, on the same images and z, for celeba64 bf16 on the
   kernel route and the cuDNN route, celeba64 f32 on the kernel route
   (TF32 off) and sagan64 bf16 on the flash route (gamma 0.5), with
   cuDNN's deterministic algorithms: every state leaf and loss equal bit
   for bit; CAPTURE_STEPS more steps with no capture and no host
   synchronization (`torch.cuda.set_sync_debug_mode("error")`); a
   replay's profile holds the port kernels at their per-step counts
   (kernels 1-4 for celeba64's kernel route, 6-8 for sagan64); capture
   ms and graph pool per program. Then, for the three bf16
   configurations: the multi-tensor Adam equal to the per-leaf one on the
   card, the launches per eager step with each (one profiled step), and
   in turns (eager, K=1, K=4, K=4, K=1, eager) the host-inclusive step
   ms, and the busy ms and idle share of the captured turns (the eager
   turns are not profiled);
13. save under capture: a save after every replayed step while the
   replays go on; each checkpoint equal to a clone of the static state
   taken right after its step, bit for bit; then the trainer's entry
   point with --steps_per_call CAPTURE_K --aot_warmup on phase 11's
   TFRecords for CLI_STEPS steps: perf/compile_ms for every plan row,
   one log line per call, kernels 1, 3, 4 at their per-step counts, the
   final checkpoint equal to the returned state;
14. generate: `python -m dcgan_tpu_torch.generate`'s entry point on phase
   11's checkpoint directory, GEN_IMAGES images in batches of GEN_BATCH
   (the tail on a smaller ladder rung), an 8x8 grid and --npz: the images
   equal to the eager sampler on the restored weights at the z rows
   rebuilt by `generate.generate_z`, bit for bit; the grid decodes; then
   --interpolate writes its grid.

The rest of the training step (`a1`):

15. a1: (1) the wgan-gp preset (64 px, gf=df=64, batch 64, n_critic 5,
   gp weight 10) through train.cli.main for A1_STEPS steps on the plain
   route, where the penalty's double backward runs: finite losses, gp > 0,
   every D leaf moved; then A1_COMPARE_STEPS steps eager against the
   runner at K=1 on the trainer's z and draws, bit for bit (cuDNN
   deterministic); (2) celeba64 on the cuDNN route with R1 gamma 10 every
   R1_INTERVAL steps, R1_STEPS steps eager against the runner at K = 1 and
   CAPTURE_K (one program per pattern of penalty and plain steps): bit for
   bit, r1 > 0 on steps 0 and 4 and 0 elsewhere; (3) celeba64 bf16 on the
   kernel route with n_critic 2, 2 microbatches and DiffAugment (color,
   translation, cutout): first kernels 1-4 against their plain versions
   at every shape of the microbatch of 32 (a1_check_kernels: bf16 and
   f32, launched twice, bit for bit, each plan logged, TRAIN_DESIGN's
   designs where the route runs them); then through train.cli.main, the
   launch counters set to 0 just before and read just after: kernels 1-4
   at exactly
   `a1_per_step(2, 2)` per step on their TRAIN_DESIGN designs; the losses
   and every gradient leaf (D's first critic update, G's, each over its
   microbatches with its draws) against the cuDNN route at the seeded
   state within TRAIN_ROUTE_TOL and TRAIN_GRAD_TOL; eager against the
   runner at K=1 bit for bit; (4) --precision bf16 at 64 px and fp8 at
   128 px (no stage of a 64 px model reaches fp8's 64 px gate; at 128 G's
   deconv4 and D's conv1 quantize) on the kernel route through
   train.cli.main, fp8's kernels first checked at its shapes as in (3)
   with fp8 operands where the stage quantizes, counters around each
   (PER_STEP; `a1_per_step(1, 1, 4)`): params bf16, Adam mu f32, the
   checkpoint restores bit for bit, the kernel route within tolerance of
   the cuDNN route; fp8's losses and gradients differ from the bf16
   step's at 128 px; the quantizer on the card equals the CPU's, bit for
   bit; (5) kernel 5 with inputs that require grad at D's stage
   shapes, bf16 and f32: a grad_fn, one launch, cotangents within
   GBSA_BWD_TOL of the plain version's autograd; (6) wgan-gp with
   use_pallas is refused; (7) one step of each configuration (and of the
   bf16 policy at 128 px) timed at K=1 (A1_TURNS: host-inclusive ms, busy
   ms, idle share), and the wgan-gp preset's eval_losses and summarize.

The native feed, the pipelined G/D step and the trainer's guards
(`feed_pipeline`):

16. feed_pipeline: FEED_RECORDS random uint8 64 px records in FEED_SHARDS
   shards; the native loader and the Python loader on the host alone on
   those and on phase 11's float64 shards (first batch s, images/s); the
   trainer's `train()` for FEED_TRAIN_STEPS steps at K=1 on the native
   uint8 feed and on the synthetic feed, kernel and cuDNN routes (the p50
   host-inclusive ms of events.jsonl), and the captured runner on the same
   feeds (ms, busy ms, idle share); pipeline_gd on the kernel route:
   PIPE_COMPARE_STEPS eager pipelined steps (a GDPipeline over the stage
   programs, drained before step PIPE_DRAIN_AT) against the runner's
   captured stage rows, every metric and leaf bit for bit, each row's
   launches of kernels 1-4 exactly `pipe_per_stage` and its graph pool;
   one pipelined step against one fused step at K=1 in turns; `train()`
   with pipeline_gd for PIPE_TRAIN_STEPS steps from the native feed with
   the counters set to 0 around it (the kernels' `pipeline_gd` path: one
   fill, PIPE_TRAIN_STEPS steady stages, one drain at the end); a NaN
   learning rate with nan_check_steps 1 must raise FloatingPointError at
   step 1 (any other error fails) and leave no checkpoint;
   fake_quant_fp8's autograd Function equal to its composed ops on the
   card, output and cotangent. The memory line also gets the a1 group's
   fp8 128 px graph pool.

The serving fleet (`serve_fleet`):

17. serve_fleet: on a copy of phase 11's celeba64 kernel-route checkpoint
   directory, the launch counters set to 0 just before and read just
   after: the serve entry point's fleet (`--fleet`) with 1 and
   FLEET_REPLICAS replicas under the same demo load (FLEET_REQUESTS
   requests of 1-8 images, Poisson at FLEET_RPS, ladder 1-64; p50, p99,
   samples/s, pad_frac, each replica's cold start ms and graph pool
   bytes); a fleet whose watcher promotes a new finalized step (G's
   weights changed, saved through the Checkpointer) while a client
   thread submits: 0 captures, every served leaf at its address, no
   request failed or dropped, swap ms per replica (the copy and the
   prime; the restore is staged on the watcher's thread while the
   replicas serve on, stage ms per replica); then one replica's
   source raises at its FLEET_FAIL_AT-th dispatch: no request fails,
   serve/fleet_unhealthy 1; after ServeFleet.stop(), with the collector
   off, no graph pool segment is left; int8 on one server (the report's
   max relative error under the JAX package's bound). Then, against
   fresh sources: the images after the promotion equal the new step's,
   bit for bit, and every client response is wholly the old or the new
   weights'; the int8 images' difference from the f32 weights; the
   checkpoint exported on the card (`export_sampler`), served through
   ArtifactSource's captured rungs, within SERVED_TOL of the plain-route
   sampler, and its rungs at FLEET_TIMED_RUNGS timed against the kernel
   route's and the cuDNN route's captured rungs.

Class conditioning and the 128 px presets (`conditional`):

18. conditional: fake CIFAR-10 python batches (COND_ROWS random uint8
   rows and labels in each of data_batch_1..5) turned into COND_SHARDS
   labelled shards by `python -m dcgan_tpu_torch.data.prepare --cifar10`'s
   entry point; kernels 1-4 against their plain versions at every shape
   of the cifar10-cond step (batch 64, 32 px, three stages, gf = df =
   64), as in phase 15; train.cli.main --preset cifar10-cond --use_pallas
   --pallas_fused on those shards for COND_STEPS steps at K=1, the
   counters set to 0 just before and read just after (kernels 1-4 at
   exactly `a1_per_step(1, 1, 2)` per step; the `cifar10_cond` path),
   finite losses, every leaf moved; at the seeded state with labels of
   every class, the losses and every gradient leaf on the kernel route
   against the cuDNN route, and with conditional_bn on use_pallas
   (kernel 1's moments, the plain per-class epilogue) against the plain
   route, within TRAIN_ROUTE_TOL and TRAIN_GRAD_TOL (bf16); the
   conditional-BN step captured at K=1 equal to eager bit for bit
   (COND_CAPTURE_STEPS steps); a conditional-BN checkpoint served and
   promoted to a newer step (0 captures, the cBN tables copied into the
   served tensors at their addresses, the images a fresh source's);
   kernels 2 and 5 against their plain versions at the conditional
   sampler's shapes at rungs COND_ARTIFACT_RUNGS; the cifar10-cond
   checkpoint served through the serve entry point (COND_DEMO_REQUESTS
   demo requests, class 0) and a server on a CheckpointSource with
   labelled requests of every class, one of mixed classes, two without
   labels and one z under two classes (which must differ), each within
   SERVED_TOL of a direct sampler call on its rows and labels, then
   generate --class_id GEN_CLASS equal to the eager sampler bit for bit,
   the counters set to 0 before the first and read after the last
   (kernels 2 and 5; the `cifar10_cond_serve` path); the checkpoint
   exported as call(z, labels) and served through ArtifactSource at
   COND_ARTIFACT_RUNGS within SERVED_TOL of the plain-route sampler;
   sagan128 (attention at 64x64, S 4096, on the flash kernels that
   phase 7 holds at that S) through train.cli.main for SAGAN128_STEPS
   steps (flash kernels at exactly SAGAN_PER_STEP per step; the
   `sagan128` path), one captured step timed and profiled (busy ms, idle
   share); dcgan128 on its preset's route (cuDNN, torch BN) for
   DCGAN128_STEPS steps, no port kernel launched (the `dcgan128` path).
19. evals: the resume checkpoint scored by `python -m
   dcgan_tpu_torch.evals`'s `evaluate` at the CLI's defaults (EVAL_SAMPLES
   samples, batch EVAL_BATCH, KID pool EVAL_KID_POOL, --kid --prdc,
   synthetic reals; the headline, and the only scoring at 50 000), after
   kernels 2 and 5 are held against their plain
   versions at the eval sampler's batch: the counters set to 0 just before
   and read just after (kernels 2 and 5 at exactly SAMPLER_PER_CALL per
   call of the captured sampler, its warm-up and its replays; the `evals`
   path), the seconds of the real pass, the sampler, the tower, the host
   statistics, FID, KID and PRDC, samples/s; then at
   EVAL_COMPARE_SAMPLES a side (a real side of their own) the kernel
   route with --kid --prdc, the same weights and z on the cuDNN route within
   EVAL_ROUTE_FID_RTOL, another z seed beside it, the kernel route again
   from the cached real side bit for bit (cuDNN deterministic), the tower's
   features on the card (TF32 on around it, as a process has it by
   default) against the CPU within EVAL_TOWER_TOL, and the error TF32
   would give; then train.cli.main on the resume group's records for
   PROBE_STEPS steps without and with --fid_every_steps PROBE_EVERY
   --fid_num_samples PROBE_SAMPLES (kernels 1-4 per step, kernels 2 and
   5 per probe sampler call; the `evals_probe` path): eval/fid and
   eval/kid at each probe, best/score.json, best/config.json and
   best/<step> of the best probe, generate on the best directory, the
   probes' seconds and the host ms per step between probes against the
   run without them.

Progressive-resolution training (`progressive`):

20. progressive: PROG_IMAGES random PNGs turned by `python -m
   dcgan_tpu_torch.data.prepare`'s entry point into shards at 32, 64 and
   128 px (`train_{res}`); kernels 1-4 (a1_check_kernels) and 2, 5
   (cond_check_serve_kernels) against their plain versions at every
   phase's shapes of dcgan128 (gf = df = 64, batch 64, bf16) on the kernel
   route; train.cli.main --preset dcgan128 --use_pallas --pallas_fused
   --progressive PROG_SPEC --progressive_fade_steps PROG_FADE
   --aot_warmup for PROG_STEPS steps with a grid in each phase, the
   counters set to 0 just before and read just after (exactly
   `prog_expected`; the `progressive` path), every capture recorded:
   only the plan's six rows (`<row>@r64`, `<row>@r128` for the later
   phases) are captured, both switch lines report the CPU trees' carry
   count and captures_during_switch=0, the rows' resolutions follow the
   schedule, each grid decodes at its phase's size; per-phase median step
   ms, switch ms, graph pools and the run's peak reserved. Then the
   switch step by step (`prog_switch_checks`): a primed runner per phase,
   `advance` and `load`, every carried leaf bit for bit its value before
   the switch; at each merged state the first step's losses and
   gradients, kernel route against the cuDNN route (TRAIN_ROUTE_TOL,
   TRAIN_GRAD_TOL); at each phase's state the captured kernel-route
   sampler within PROG_SAMPLER_TOL of the cuDNN route's. Last, a run that
   saves every step to PROG_RESUME_AT: generate on the step-PROG_GEN_AT
   checkpoint alone builds the 64 px model with no flags, and a resume
   from the step-PROG_RESUME_AT checkpoint (tagged phase 1, r64) starts
   in phase 1 and switches to r128.

The resnet and stylegan model families (`families`):

21. families: kernels 1-3 against their plain versions at every BatchNorm
   shape of sngan-cifar10's resnet generator (gf = df = 64, batch 64; 2k
   + 1 = 7 BatchNorms), bf16 and f32, each launched twice and bit for
   bit, each launch's design logged; train.cli.main --preset
   sngan-cifar10 --use_pallas on `prepare --cifar10` shards of random
   arrays for FAM_STEPS steps, the counters set to 0 around it: exactly
   `fam_per_step` (n_critic 5, the `sngan_cifar10` path), every leaf
   moved; at the seeded state the losses and every gradient leaf, kernel
   route against the cuDNN + torch-BN route, within TRAIN_ROUTE_TOL and
   TRAIN_GRAD_TOL in bf16 and (TF32 off) f32; the captured runner at K=1
   equal to eager bit for bit; WGAN-GP under use_pallas (gp > 0, the same
   counts; `resnet_wgan_gp`); the attention block at FAM_ATTN_RES on the
   flash kernels (kernels 6-8 and 1-3 at exactly their counts,
   `resnet_attention`; the flash route against the dense route within
   ATTN_ROUTE_TOL and ATTN_GRAD_TOL); train.cli.main --preset stylegan64
   --synthetic for STYLEGAN_STEPS captured steps with no port kernel, R1
   > 0 exactly at steps 0 and 16, eager against the runner over the R1
   pattern bit for bit; both checkpoints served through the entry point
   (recompiles_after_warmup 0), each rung's capture holding kernel 2 at
   every BatchNorm (none for stylegan), generate equal to the eager
   sampler bit for bit, the export served through ArtifactSource within
   SERVED_TOL, the evals CLI at FAM_EVAL_SAMPLES samples; one captured
   step of each preset timed and profiled; the group's seconds.

Fault tolerance in one process (`faults`), celeba64 on the kernel route
(gf = df = 64, batch 64, --aot_warmup, cuDNN deterministic):

22. faults: at K=1 and K=4, train.cli.main with --nan_policy rollback
   --rollback_snapshot_steps FAULT_SNAPSHOT under DCGAN_CHAOS
   {"nan_at_step": FAULT_NAN_STEP}, the counters set to 0 just before
   and read just after: kernels 1-4 at exactly PER_STEP x the steps the
   card ran (FAULT_EXECUTED: those up to the NaN and the replayed ones;
   the `faults_k1` and `faults_k4` paths), one restore to the snapshot
   that captured nothing, anomaly/rollbacks 1 from the failing step on,
   the run at FAULT_STEPS; a runner per K timed on the snapshot and the
   restore (CUDA events and host clock) and on the rollback to the next
   replay's readback, its restored state equal to the snapshot and its
   first replay after the restore equal to eager steps from the snapshot
   bit for bit, a replay's launches the same before and after the
   restore; the same rollback under --pipeline_gd draining the fake
   stack; a NaN under the abort policy leaving a flight-recorder dump
   whose last record is the failing step; the same fed K=1 run
   (FAULT_TIMED_STEPS steps, a grid and activations every
   FAULT_TELEMETRY_EVERY) with --async_services true and false writing
   the same JSONL but for the wall-clock perf/* keys and the time, each
   run's step ms from its own StepTimer against the captured step's busy
   ms and the idle share; and `python -m dcgan_tpu_torch.train` in a
   subprocess with --collective_timeout_secs FAULT_WATCHDOG_SECS and a
   hang at FAULT_HANG_STEP exiting 43 with every thread's stack and a
   dump naming `step-dispatch`.

The trainer's own trace capture (`trace`), celeba64 on the kernel route
(gf = df = 64, batch 64, bf16, K=1, --aot_warmup, synthetic feed):

23. trace: train.cli.main for TRACE_STEPS steps with --profile_dir (a
   window opened at step TRACE_START: a warm-up call, then TRACE_WINDOW
   recorded steps) and --profile_trigger (the file touched at the
   boundary TRACE_TRIGGER_AT, between two calls), --timing_window 1 and
   a row every step; then TRACE_PIPE_STEPS steps under --pipeline_gd
   with a scheduled window; the launch counters set to 0 before the
   first and read after the second (the `trace` path) and read around
   each window's recorded steps (TraceCapture's open, warm-up end and
   stop patched). Fails unless (a) every digest read the gpu track, (b)
   each port kernel's launches in each window's trace equal the
   counters around it, (c) perf/device/step_ms lies between
   TRACE_STEP_BOUNDS[0] x the busy ms profile_split(settle=True) gives
   for the same captured step and TRACE_STEP_BOUNDS[1] x the host p50 of
   the steps outside the windows, (d) the first run made two captures,
   consumed the trigger and wrote two digest rows, (e) the pipelined
   window's step is the sum of its d_update and g_update medians, (f)
   perf/startup/{init,restore,data,warmup,total}_ms are in the startup
   row and total is at least the phases' sum, (g)
   tools/trace_summary_torch.py exits 0 on a written trace. Logs what
   Kineto names the device tracks, each window's compute, idle gap, span
   and step ms, its top TRACE_TOP kernels, stop-and-export ms, trace
   bytes and digest seconds, the host p50 inside and outside the windows
   and the group's seconds.

Data parallelism over processes (`multi_gpu`, parallel/):

24. multi_gpu: (a) celeba64 on the kernel route through
   `initialize_multihost` (NCCL, one rank) and `make_parallel_train`,
   through StepRunner at K=1 and K=CAPTURE_K beside the non-distributed
   runner on the same seeded state, images and z: the losses and every
   state leaf bit for bit after every call, kernels 1-4 at PER_STEP a
   step on both, the collectives the step issues on the host in the
   warm-up and in the capture and none in a replay; logs the NCCL kernels
   a replay holds and each route's busy ms, host ms and idle share; (b)
   `train.cli.main --preset sagan256-lc --synthetic` (256 px, batch 64,
   attention at S 16384, the shard_map draws) for MG_SAGAN_STEPS steps
   through the world-1 NCCL group, the counters set to 0 before and read
   after (kernels 6-8 a whole number of times a step), the attention
   shapes the path gave kernels 6-8 recorded, the kernels at the S 16384
   one held against their plain versions over FLASH_ROWS rows and timed
   beside their bound, then one step through the world-1 runner, captured
   if it fits, with its host ms, busy ms, idle share and memory peak; (c)
   lsun64-dp8 (use_pallas, pallas_fused, global batch 512) as 8 gloo
   ranks sharing the card (`testing/multihost.py::run_world`, under
   MG_DP8_TIMEOUT): the gradients at the seeded state in bf16 and f32
   and MG_DP8_STEPS eager steps; every rank's state bit for bit equal,
   kernels 1-4 at PER_STEP a step on every rank, the gloo step's runner
   eager (its program records no graph); the 8-rank gradients against
   one rank's on the global batch within TRAIN_GRAD_TOL, the losses
   within TRAIN_ROUTE_TOL and the parameters within Adam's bound 2 * lr
   * steps. Logs whether gloo took the CUDA tensors or the collectives
   staged through host memory, and each part's seconds.

The spatial mesh and sequence-parallel attention (`spatial`,
parallel/spatial.py, ops/attention.py, ops/flash_attention.py):

25. spatial: (a) kernels 7 and 8 with f32 gradient outputs from bf16
   operands (`out_dtype=torch.float32`, the ring backward's) at
   SP_F32_SHAPES (sagan128's S 4096 at batch 64; sagan256-lc's S 16 384
   over four blocks, the local ring's launch at [256, 4096]), launched
   twice (the same bits) and held against their plain versions over
   FLASH_ROWS rows within kernel_error_bounds, timed beside their bound;
   (b) ring x flash over a LocalRing of n blocks (SP_RINGS: sagan128's
   S 4096 at n = 2, 4 in bf16 and f32, sagan256-lc's S 16 384 at n = 2,
   4, heads of 16/64 at n = 2) against flash over the whole sequence:
   n flash_fwd, n flash_dq and n flash_dkv launches a forward and
   backward, out, lse, dq, dk, dv over FLASH_ROWS rows within twice
   kernel_error_bounds (one more bf16 ulp a side), every row finite,
   both timed; (c) sagan128 with --mesh_model 2 --mesh_spatial (ring)
   and (d) sagan64 with --mesh_data 2 --mesh_model 2 --mesh_spatial
   --seq_strategy ulysses --attn_heads 2, as 2 and 4 gloo ranks sharing
   the card (run_world, under SP_TIMEOUT): on every rank one f32 step of
   the world's programs (TF32 off) on a seeded global batch, then
   SP_STEPS bf16 steps through train.cli.main (eager: gloo), the counters
   set to 0 before and read after; every rank's losses and states the
   same; the f32 step's losses within 1e-4 relative of the world of
   one's step on the same init, batch and draws; by sp_hold_step both
   nets' gradients at the init (`fns.grads`) per leaf within
   TRAIN_GRAD_TOL float32, and the parameters within SP_PARAM_ATOL where
   the applied gradients (Adam's mu: beta1 is 0) agree in sign clear of
   Adam's eps, 2 * lr + 1e-5 where one flips; kernels 6-8 at world 1's
   launches times the ring's size (ring) or equal (Ulysses) in the f32
   step and launched on every rank by the trainer. Logs the staged
   calls, which collectives gloo took on CUDA tensors, the host ms of
   each trainer step and each part's seconds.

At the end of each group of phases (the kernel checks, serve, train,
sagan64, resume, capture, a1, feed_pipeline, serve_fleet, conditional,
evals, progressive, families, faults, trace, multi_gpu, spatial) the
garbage is collected and
the cache emptied; the run fails if a CUDA graph's private pool is still
reserved then (every runner is closed, so a pool left over is a leak that would
starve the phases after it), and it logs the group's peak and the bytes
left allocated and reserved.

Stdout ends with the serve reports, the sampler timing, the train
reports, the resume report, the capture report, the a1 report, the
feed_pipeline report, the serve_fleet report, the conditional report,
the evals report, the progressive report, the families report, the
faults report, the trace report, the multi_gpu report, the spatial
report, the memory report, the progressive
group's timing line (median step ms per phase, switch ms, graph pools,
the group's peak reserved, the card), the families group's timing line
(each preset's captured step ms, busy ms, idle share; the group's
seconds and peak reserved; the card), the faults group's timing line
(snapshot, restore and rollback-to-replay ms per K; the fed K=1 step's
ms, busy ms and idle share with the services async and inline; the
group's seconds and peak reserved; the card), the trace group's timing
line (each window's stop-and-export ms, trace bytes and digest seconds,
the perf/device rows, the host p50 inside and outside the windows, the
captured step's busy ms; the group's seconds; the card), the multi_gpu
group's timing line (each route's busy, host ms and idle share
and the NCCL kernels per replay at world 1; sagan256-lc's step, memory and
kernels 6-8 at S 16384; the 8 ranks' seconds, staging and gaps; the
group's seconds; the card), the spatial group's timing line (the
f32-output kernels' ms and bounds, the local ring's ms against whole
flash, each world's seconds, staged calls, host ms a step, launches and
parameter gaps; the group's seconds and peak reserved; the card), the
card's name and power limit
(nvidia-smi), one JSON line
{"kernels": [...]} and, last, one JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero, printing no result, when no GPU is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over HBM bandwidth and its operations over these rates
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
# exponentials: 16 MUFU ex2 per clock per SM, 132 SMs at 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9

BATCH = 64
N_REQUESTS = 24
SEED = 0

# Tolerances, max |kernel - plain| <= RTOL * |plain| + ATOL elementwise.
# bf16 output: one bf16 ulp of the value (2^-7 relative at most), since the
# two sum in different orders in f32 and may round to neighbours; the atol
# covers f32 summation-order noise around 0 (sums of <= 12800 products).
TOL = {"bfloat16": (2.0 ** -7, 1e-4), "float32": (1e-5, 1e-4)}
# Served images (tanh range) against the cuDNN + torch-BN route on the same
# weights: in bf16 the routes round at different points through 4 stages
# (torch BN computes in bf16, the kernels in f32); in f32, with TF32 off,
# only the summation order differs.
ROUTE_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# Served request vs a direct sampler call on its z rows: the same route;
# only cuBLAS/cuDNN algorithm choice at another batch size may differ.
SERVED_TOL = 2e-2
# The four losses at the seeded state, kernel route vs cuDNN + torch-BN
# route, same state, images and z, as (rtol, atol) on |kernel - cudnn| <=
# rtol * |cudnn| + atol: in bf16 the routes round at different points
# through G and D (BN in bf16 op by op vs f32 with one rounding), at most
# two bf16 ulps relative (measured 0.28 % on an H100 at 700 W); in f32
# with TF32 off only the summation order differs (measured 4.4e-7
# relative).
TRAIN_ROUTE_TOL = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-5, 1e-6)}
# The gradients at the seeded state, per leaf of each net, kernel route vs
# cuDNN + torch-BN route: |g_kernel - g_cudnn| <= rtol * |g_cudnn| + atol *
# (the net's largest leaf norm), norms over the leaf. The atol term covers
# the biases that feed a BatchNorm, whose true gradient is 0 (their
# gradient is rounding noise, as large as itself on either route). G's
# gradients pass back through D and G, so bf16 rounding reaches them
# amplified: the routes measured 19 % apart on G's leaves and 10 % on D's
# in bf16, 0.24 % in f32 (H100 at 700 W). Broken backwards measured: dscale
# zeroed, 100-137 % on every BN scale; gemm_bias_moments' E[u^2] cotangent
# dropped, 40-200 % on the BN leaves; dscale 2 % off, 2-2.6 % on the BN
# scales in f32; channel_moments' E[x^2] cotangent dropped, 5.1 % on G's
# proj in f32. `broken_backwards` injects the first two in bf16 and the
# last two in f32, and the run fails unless the comparison catches each.
TRAIN_GRAD_TOL = {"bfloat16": (0.3, 1e-2), "float32": (1e-2, 1e-5)}
TRAIN_STEPS = 10
# launches per training step (n_critic 1, sequential): G runs forward
# twice (D step, G step) and D three times (real and fake in the D step,
# fake in the G step); backward passes run D's stages three times and G's
# once (bn0 + its 3 fused stages)
PER_STEP = {"channel_moments": 2, "scale_shift_act": 17,
            "scale_shift_act_bwd": 13, "gemm_bias_moments": 15,
            "gemm_bias_scale_act": 0, "flash_fwd": 0, "flash_dq": 0,
            "flash_dkv": 0}
# sagan64 (attention on the kernels, BN plain): G forwards twice and D three
# times per step, one attention block each; backward passes D's block twice
# in the D step (real, fake) and D's and G's once each in the G step
SAGAN_PER_STEP = dict({name: 0 for name in PER_STEP}, flash_fwd=5,
                      flash_dq=4, flash_dkv=4)
# Flash attention on the sagan64 state (gamma 0.5), flash route vs dense
# route, same state, images and z. Losses as (rtol, atol); gradients per
# leaf as in TRAIN_GRAD_TOL (rtol on the leaf's norm, atol times the net's
# largest leaf norm). The routes share every op but the attention: in
# bf16 the flash route rounds p to bf16 before dividing by l, the dense
# route after, so the attention output differs by ~2^-8 relative and G's
# gradients, which pass back through D and G, by more (G's proj weights
# measured at 0.73 of the bf16 limit, the same in two runs on an H100 at
# 700 W). In f32 (TF32 off) only the summation order differs, but a leaf
# whose gradient is a batch sum with cancellation carries that noise
# amplified and varies from run to run: D's conv0 bias measured from
# below 0.43 to 1.02 of a (1e-3, 1e-6) limit in two runs, so f32 takes the
# celeba64 route check's limit (TRAIN_GRAD_TOL); the broken backwards
# measured at ~900 and ~3000 times the (1e-3, 1e-6) limit.
ATTN_ROUTE_TOL = {"bfloat16": (2.0 ** -6, 1e-3), "float32": (1e-5, 1e-6)}
ATTN_GRAD_TOL = {"bfloat16": (0.1, 1e-3), "float32": (1e-2, 1e-5)}


# The design of the gemm_bias_scale_act kernel on the served bf16 stages
# (ops/fused.py::gbsa_plan; v1: WMMA from padded shared rows, v2: TMA-fed
# wgmma)
GBSA_DESIGN = "v2"
# The designs of gemm_bias_moments (the same plan), scale_shift_act's
# forward and backward (ops/kernels.py::ssa_fwd_design, ::ssa_bwd_design;
# vector: 16-byte loads) and channel_moments (ops/kernels.py::moments_plan)
# on every launch of the celeba64 bf16 training step; the served path's
# scale_shift_act launches take the same forward design
TRAIN_DESIGN = {"gemm_bias_moments": "v2", "scale_shift_act_bwd": "vector",
                "scale_shift_act": "vector", "channel_moments": "vector"}
# Hopper instructions each redesigned kernel's machine code must hold
# (cuobjdump -sass of the built library), by a part of its entries'
# mangled names: TMA loads and wgmma in every gbsa_wgmma_kernel<BN, OutT>
# and gbm_wgmma_kernel<BN>, ldmatrix and the ex2 MUFU op in every bf16
# flash_dq_kernel<DKP, DVP>; 128-bit read-only loads and 128-bit stores in
# every ssa_fwd_vec_kernel<T, VEC, ACT>; the cluster barrier (arrive and
# wait) in every moments_cluster_kernel<T, VEC>, and 128-bit read-only
# loads of x in its vector entries (<bf16, 8>, <float, 4>; the finish's
# 128-bit loads are .STRONG.GPU and do not count)
HOPPER_SASS = {
    "gemm_bias_scale_act": (("17gbsa_wgmma_kernelI", ("HGMMA", "UTMALDG")),),
    "gemm_bias_moments": (("16gbm_wgmma_kernelI", ("HGMMA", "UTMALDG")),),
    "flash_attention": (("15flash_dq_kernelI", ("LDSM", "MUFU.EX2")),),
    "scale_shift_act": (("18ssa_fwd_vec_kernelI",
                         ("LDG.E.128.CONSTANT", "STG.E.128")),),
    "channel_moments": (
        ("22moments_cluster_kernelI", ("UCGABAR_ARV", "UCGABAR_WAIT")),
        ("22moments_cluster_kernelI13__nv_bfloat16Li8E",
         ("LDG.E.128.CONSTANT",)),
        ("22moments_cluster_kernelIfLi4E", ("LDG.E.128.CONSTANT",)))}
# Entries (a part of their mangled names) that must build without spilling:
# gemm_bias_moments' v2 keeps 2 x BN / 8 moment sums out of registers by
# reducing n8 tile by n8 tile
NO_SPILLS = ("16gbm_wgmma_kernelI",)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# the script's start: each log line carries the seconds since it
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke] [{time.perf_counter() - _T0:7.1f} s] {msg}",
          flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 2, label: str = "fn"):
    """(device ms, call ms) of one fn().

    call ms: host clock around `iters` back-to-back calls ending in a
    synchronize, so it includes the wrapper's Python and launch overhead.
    device ms: the median of three windows of CUDA events, each around
    ceil(iters / 3) calls enqueued behind a spin kernel that holds the
    stream until the host has queued them all, so the calls run back to
    back on the card and host overhead is hidden. The median drops a window
    that caught a stall (a single window once read 16x the profiler's
    kernel time). The three readings are logged under `label`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    n = max(1, -(-iters // 3))
    readings = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # cycles >= twice the enqueue time at clocks up to 2 GHz, plus 5
        # ms: a host-bound fn() enqueues about as slowly as the first loop
        torch.cuda._sleep(int((2.0 * call_ms * n + 5.0) * 2e6))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / n)
    ms = sorted(readings)[1]
    log(f"timed {label}: {', '.join(f'{r:.4f}' for r in readings)} ms per "
        f"call in 3 windows of {n}, median {ms:.4f}; host-inclusive "
        f"{call_ms:.4f} ms")
    return ms, call_ms


# the bytes that pass through the card between two calls on one copy of an
# operand in time_from_hbm: three times the H100's 50 MB L2
RING_BYTES = 150 * 2 ** 20


def time_from_hbm(torch, fn, operand, traffic: int, label: str):
    """Device ms of one fn(operand) with its operand read from HBM and not
    the L2, where time_ms's back-to-back calls on one tensor may keep an
    operand of a few MB in the 50 MB L2. fn runs over a ring of copies of
    `operand`, enough that RING_BYTES of `traffic` (the bytes one call
    moves) pass between two calls on one copy; its results are kept alive in
    a ring of the same length, so its outputs rotate through as many
    buffers. time_ms's median of three windows, each about one turn of the
    ring. Returns (ms, copies)."""
    copies = max(2, -(-RING_BYTES // traffic))
    ring = [operand.clone() for _ in range(copies)]
    outs = [None] * copies
    turn = [0]

    def step():
        i = turn[0] % copies
        turn[0] += 1
        outs[i] = fn(ring[i])

    ms, _ = time_ms(torch, step, max(50, 3 * copies),
                    label=f"{label} from HBM, a ring of {copies}")
    return ms, copies


def check_close(torch, name, got, want, dtype_name):
    rtol, atol = TOL[dtype_name]
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    bad = err > rtol * w.abs() + atol
    max_err = float(err.max()) if err.numel() else 0.0
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} element(s) outside "
             f"rtol={rtol} atol={atol}; max |err| {max_err:.3g}")
    return max_err


def gemm_bound(m, k, c):
    bytes_ = 2 * m * k + 2 * k * c + 3 * 4 * c + 2 * m * c
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = 2.0 * m * k * c / BF16_TENSOR_FLOPS + 4.0 * m * c / F32_FLOPS
    return t_bytes, t_ops


def ssa_bound(n, c):
    t_bytes = (2 * 2 * n * c + 2 * 4 * c) / HBM_BYTES_PER_S
    t_ops = 3.0 * n * c / F32_FLOPS
    return t_bytes, t_ops


def stage_shapes(cfg, batch):
    """(name, M, K, C, in_res, in_ch) of every fused interior stage."""
    k = cfg.num_up_layers
    out = []
    for i in range(1, k):
        in_ch = cfg.gf_dim * 2 ** (k - i)
        res = cfg.base_size * 2 ** i
        out.append((f"deconv{i}", batch * res * res,
                    in_ch * cfg.kernel_size ** 2,
                    cfg.gf_dim * 2 ** (k - 1 - i), res // 2, in_ch))
    return out


def at_offset(torch, t, offset):
    """A contiguous copy of t that starts `offset` elements into its own
    buffer (t itself for offset 0): a pointer off 16-byte alignment."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def entry_report(ptxas, part):
    """registers and spill bytes of the one ptxas entry whose mangled name
    holds `part`."""
    found = [e for e in ptxas if part in e["entry"]]
    if len(found) != 1:
        fail(f"{len(found)} ptxas entries match {part}")
    return {"registers": found[0].get("registers"),
            "spill_bytes": (found[0].get("spill_stores", 0)
                            + found[0].get("spill_loads", 0))}


def gbsa_entry_report(ptxas, bn):
    """The v2 gemm_bias_scale_act entry at column tile `bn` with a bf16
    output (gbsa_wgmma_kernel<bn, bf16>)."""
    return entry_report(ptxas, f"17gbsa_wgmma_kernelILi{bn}E13__nv_bfloat16E")


def gbm_entry_report(ptxas, bn):
    """The v2 gemm_bias_moments entry at column tile `bn`
    (gbm_wgmma_kernel<bn>)."""
    return entry_report(ptxas, f"16gbm_wgmma_kernelILi{bn}EE")


def reset_counts(wrappers):
    """Every wrapper's launch count, and its count by design, set to 0."""
    for fn in wrappers.values():
        fn.launches = 0
        by_design = getattr(fn, "launches_by_design", {})
        for design in by_design:
            by_design[design] = 0


def check_kernels(torch, cfg, ptxas):
    """Phase 2: kernels vs plain versions, then timings. Returns the
    per-kernel entries of the kernels line (launches filled later);
    `ptxas` is the build's ptxas reports (`_build.ptxas_report`)."""
    from dcgan_tpu_torch.ops.activations import ACTS
    from dcgan_tpu_torch.ops.fused import conv_patches, \
        gbsa_plan, gemm_bias_scale_act, gemm_bias_scale_act_plain, w_to_gemm
    from dcgan_tpu_torch.ops.kernels import scale_shift_act, \
        scale_shift_act_plain, sm_count

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def vectors(c):
        return (rand(c, lo=-0.1, hi=0.1), rand(c, lo=0.5, hi=1.5),
                rand(c, lo=-0.5, hi=0.5))

    # ---- scale_shift_act at bn0: x [16 B, 8 gf] -------------------------
    top = cfg.gf_dim * 2 ** (cfg.num_up_layers - 1)
    n0 = BATCH * cfg.base_size ** 2
    ssa = {"name": "scale_shift_act", "route": "cuda",
           "source": "dcgan_tpu_torch/csrc/scale_shift_act.cu",
           "replaces": "dcgan_tpu/ops/pallas_kernels.py:151",
           "shape": [n0, top]}
    errs = {}
    by_design = scale_shift_act.launches_by_design
    # the served shape on the vector design, then a ragged shape and the
    # served shape 2 elements off 16-byte alignment on the scalar design
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        for shape, offset, design in (((n0, top), 0, "vector"),
                                      ((37, 70), 0, "scalar"),
                                      ((n0, top), 2, "scalar")):
            x = at_offset(torch, rand(*shape).to(dt), offset)
            _, scale, shift = vectors(shape[1])
            for act in ACTS:
                before = dict(by_design)
                got = scale_shift_act(x, scale, shift, act)
                want = scale_shift_act_plain(x, scale, shift, act)
                torch.cuda.synchronize()
                tag = f"{dt_name} {shape} +{offset} {act}"
                if by_design != dict(before, **{design: before[design] + 1}):
                    fail(f"scale_shift_act {tag} did not take design "
                         f"{design}: {before} -> {by_design}")
                err = check_close(torch, f"scale_shift_act {tag}", got, want,
                                  dt_name)
                if (shape, offset) == ((n0, top), 0):
                    errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            log(f"scale_shift_act {dt_name} {shape} +{offset} takes design "
                f"{design} and matches its plain version at every act")
    log(f"scale_shift_act matches its plain version (max |err| bf16 "
        f"{errs['bfloat16']:.3g}, f32 {errs['float32']:.3g})")
    ssa.update(entry_report(ptxas, "18ssa_fwd_vec_kernelI13__nv_bfloat16Li8E"
                                   "Li1E"))
    x = rand(n0, top).clamp_min(0).to(torch.bfloat16)
    _, scale, shift = vectors(top)
    ssa["ms"], ssa["call_ms"] = time_ms(
        torch, lambda: scale_shift_act(x, scale, shift, "relu"), 200,
        label="k2 bn0")
    ssa["plain_ms"], _ = time_ms(torch, lambda: scale_shift_act_plain(
        x, scale, shift, "relu"), 100, label="k2 plain bn0")
    ssa["library_ms"], _ = time_ms(torch, lambda: torch.relu(
        x.float() * scale + shift).to(x.dtype), 100, label="k2 library bn0")
    t_bytes, t_ops = ssa_bound(n0, top)
    ssa["bound_ms"] = max(t_bytes, t_ops) * 1e3
    ssa["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    ssa["max_abs_err"] = errs["bfloat16"]
    ssa["max_abs_err_f32"] = errs["float32"]

    # ---- gemm_bias_scale_act at the fused stages -------------------------
    gemm = {"name": "gemm_bias_scale_act", "route": "cuda",
            "source": "dcgan_tpu_torch/csrc/gemm_bias_scale_act.cu",
            "replaces": "dcgan_tpu/ops/pallas_fused.py:229",
            "design": GBSA_DESIGN, "stages": []}
    by_design = gemm_bias_scale_act.launches_by_design
    # ragged M, K and C, every act: an aligned shape on v2 (bf16 operands,
    # bf16 and f32 outputs), then K 37 and C 70 on v1 (bf16) and SIMT (f32)
    ragged = [(1000, 200, 72, torch.bfloat16, torch.bfloat16, "v2"),
              (1000, 200, 72, torch.bfloat16, torch.float32, "v2"),
              (100, 37, 70, torch.bfloat16, torch.bfloat16, "v1"),
              (100, 37, 70, torch.float32, torch.float32, "simt")]
    for act in ACTS:
        for m, k, c, in_dt, out_dt, design in ragged:
            p, w = rand(m, k).to(in_dt), (0.1 * rand(k, c)).to(in_dt)
            b, scale, shift = vectors(c)
            before = dict(by_design)
            got = gemm_bias_scale_act(p, w, b, scale, shift, act,
                                      out_dtype=out_dt)
            again = gemm_bias_scale_act(p, w, b, scale, shift, act,
                                        out_dtype=out_dt)
            torch.cuda.synchronize()
            if by_design[design] != before[design] + 2:
                fail(f"gemm_bias_scale_act ragged {(m, k, c)} did not take "
                     f"design {design}: {before} -> {by_design}")
            tag = f"{(m, k, c)} {design} {str(out_dt)[6:]} {act}"
            same_bits(torch, f"gemm_bias_scale_act ragged {tag}", (got,),
                      (again,))
            out_name = "bfloat16" if out_dt is torch.bfloat16 else "float32"
            check_close(torch, f"gemm_bias_scale_act ragged {tag}", got,
                        gemm_bias_scale_act_plain(p, w, b, scale, shift, act,
                                                  out_dtype=out_dt),
                        out_name)
    log(f"gemm_bias_scale_act ragged shapes match their plain versions and "
        f"repeat bitwise on designs v2, v1 and simt, every act")
    for name, m, k, c, res, in_ch in stage_shapes(cfg, BATCH):
        # operands as the served path builds them: post-relu activations
        # through the zero-dilated im2col, HWIO weights reshaped
        stage = {"stage": name, "m": m, "k": k, "c": c}
        for dt_name, dt in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            h = rand(BATCH, res, res, in_ch, lo=0.0, hi=1.0).to(dt)
            p2d, _ = conv_patches(h, cfg.kernel_size, 2, transpose=True)
            w2d = w_to_gemm(0.02 * torch.randn(
                (cfg.kernel_size, cfg.kernel_size, in_ch, c), generator=g,
                device=dev)).to(dt)
            b, scale, shift = vectors(c)
            if tuple(p2d.shape) != (m, k):
                fail(f"{name}: patches {tuple(p2d.shape)} != {(m, k)}")
            plan = gbsa_plan(m, k, c, dt, True, sm_count(dev))
            before = by_design[plan.design]
            got = gemm_bias_scale_act(p2d, w2d, b, scale, shift, "relu",
                                      out_dtype=dt)
            again = gemm_bias_scale_act(p2d, w2d, b, scale, shift, "relu",
                                        out_dtype=dt)
            want = gemm_bias_scale_act_plain(p2d, w2d, b, scale, shift,
                                             "relu", out_dtype=dt)
            torch.cuda.synchronize()
            if by_design[plan.design] != before + 2:
                fail(f"gemm_bias_scale_act {name} {dt_name} did not take "
                     f"its plan's design {plan.design}")
            same_bits(torch, f"gemm_bias_scale_act {name} {dt_name}",
                      (got,), (again,))
            stage[f"max_abs_err_{dt_name}"] = check_close(
                torch, f"gemm_bias_scale_act {name} {dt_name}", got, want,
                dt_name)
            del got, again, want
            if dt is torch.bfloat16:
                if plan.design != GBSA_DESIGN:
                    fail(f"{name}: the served bf16 stage plans design "
                         f"{plan.design}, not {GBSA_DESIGN}")
                stage["plan"] = plan._asdict()
                stage.update(gbsa_entry_report(ptxas, plan.bn))
                stage["ms"], stage["call_ms"] = time_ms(
                    torch, lambda: gemm_bias_scale_act(
                        p2d, w2d, b, scale, shift, "relu",
                        out_dtype=torch.bfloat16), 20, label=f"k5 {name}")
                stage["plain_ms"], _ = time_ms(
                    torch, lambda: gemm_bias_scale_act_plain(
                        p2d, w2d, b, scale, shift, "relu",
                        out_dtype=torch.bfloat16), 10,
                    label=f"k5 plain {name}")
                stage["library_ms"], _ = time_ms(torch, lambda: torch.relu(
                    (torch.matmul(p2d, w2d).float() + b) * scale + shift
                ).to(torch.bfloat16), 20, label=f"k5 library {name}")
                # the im2col that feeds the kernel on the served path
                stage["im2col_ms"], _ = time_ms(torch, lambda: conv_patches(
                    h, cfg.kernel_size, 2, transpose=True), 10,
                    label=f"im2col {name}")
                t_bytes, t_ops = gemm_bound(m, k, c)
                stage["bound_ms"] = max(t_bytes, t_ops) * 1e3
                stage["bound_by"] = "bytes" if t_bytes >= t_ops \
                    else "operations"
            del h, p2d, w2d
            torch.cuda.empty_cache()
        log(f"gemm_bias_scale_act {name} M={m} K={k} C={c} matches its "
            f"plain version and repeats bitwise (max |err| bf16 "
            f"{stage['max_abs_err_bfloat16']:.3g}, f32 "
            f"{stage['max_abs_err_float32']:.3g}); bf16 plan "
            f"{stage['plan']} ({stage['registers']} registers, "
            f"{stage['spill_bytes']} B spilled); {stage['ms']:.4f} ms vs "
            f"bound {stage['bound_ms']:.4f} ms ({stage['bound_by']}); "
            f"library {stage['library_ms']:.4f} ms; plain "
            f"{stage['plain_ms']:.4f} ms; its im2col "
            f"{stage['im2col_ms']:.4f} ms")
        gemm["stages"].append(stage)
    st = gemm["stages"]
    for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                "im2col_ms"):
        gemm[key] = sum(s[key] for s in st)   # one sampler call at B=64
    gemm["bound_by"] = "bytes" if all(s["bound_by"] == "bytes"
                                      for s in st) else "operations"
    gemm["max_abs_err"] = max(s["max_abs_err_bfloat16"] for s in st)
    gemm["max_abs_err_f32"] = max(s["max_abs_err_float32"] for s in st)
    gemm["registers"] = max(s["registers"] for s in st)
    gemm["spill_bytes"] = max(s["spill_bytes"] for s in st)
    log(f"gemm_bias_scale_act per sampler call at batch {BATCH} "
        f"({GBSA_DESIGN} design): {gemm['ms']:.4f} ms vs bound "
        f"{gemm['bound_ms']:.4f} ms; library {gemm['library_ms']:.4f} ms")
    return [ssa, gemm]


def train_shapes(cfg, batch):
    """The fused stages of one training step: G's deconv1..k-1 and D's
    conv1..k-1, as dicts of name, transpose, act, GEMM M/K/C, the input
    map's resolution and channels, and launches per step (G forwards twice
    per step, D three times)."""
    out = [dict(name=f"G {name}", transpose=True, act="relu", m=m, k=k,
                c=c, res=res, in_ch=in_ch, fwd=2, bwd=1)
           for name, m, k, c, res, in_ch in stage_shapes(cfg, batch)]
    for i in range(1, cfg.num_up_layers):
        in_ch = cfg.df_dim * 2 ** (i - 1)
        out_res = cfg.output_size >> (i + 1)
        out.append(dict(name=f"D conv{i}", transpose=False, act="lrelu",
                        m=batch * out_res * out_res,
                        k=in_ch * cfg.kernel_size ** 2,
                        c=cfg.df_dim * 2 ** i, res=cfg.output_size >> i,
                        in_ch=in_ch, fwd=3, bwd=3))
    return out


def moments_bound(n, c, itemsize):
    t_bytes = (itemsize * n * c + 2 * 4 * c) / HBM_BYTES_PER_S
    t_ops = 3.0 * n * c / F32_FLOPS
    return t_bytes, t_ops


def ssa_bwd_bound(n, c, itemsize):
    # reads x and g, writes dx; reads scale/shift, writes dscale/dshift
    t_bytes = (3 * itemsize * n * c + 4 * 4 * c) / HBM_BYTES_PER_S
    t_ops = 8.0 * n * c / F32_FLOPS
    return t_bytes, t_ops


def gbm_bound(m, k, c, itemsize):
    # reads P, W and b, writes u (f32) and the two moment vectors
    bytes_ = itemsize * (m * k + k * c) + 4 * c + 4 * m * c + 2 * 4 * c
    rate = BF16_TENSOR_FLOPS if itemsize == 2 else F32_FLOPS
    return bytes_ / HBM_BYTES_PER_S, 2.0 * m * k * c / rate \
        + 4.0 * m * c / F32_FLOPS


def column_sum_close(torch, name, got, want, terms):
    """A column sum taken in another order: within 1e-5 of the sum of the
    terms' magnitudes, plus 1e-6. Returns max |got - want|."""
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    bad = err > 1e-5 * terms + 1e-6
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} column(s) outside 1e-5 * "
             f"sum|terms| + 1e-6; max |err| {float(err.max()):.3g}")
    return float(err.max())


def same_bits(torch, name, a, b):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name}: two launches on the same inputs differ")


def weighted(entries, key):
    """Launch-weighted sum over shapes: the time per training step."""
    return sum(e[key] * e["per_step"] for e in entries)


def check_moments(torch, tag, x):
    """Kernel 1 launched twice on the plan moments_plan makes: that design
    taken, the same bits twice, the plain version matched as column sums.
    Returns (max |err|, the plan)."""
    from dcgan_tpu_torch.ops.kernels import channel_moments, \
        channel_moments_plain, moments_plan, sm_count

    designs = channel_moments.launches_by_design
    plan = moments_plan(*x.shape, x.dtype, x.data_ptr() % 16 == 0,
                        sm_count(x.device))
    before = dict(designs)
    got, again = channel_moments(x), channel_moments(x)
    want = channel_moments_plain(x)
    torch.cuda.synchronize()
    if designs != dict(before, **{plan.design: before[plan.design] + 2}):
        fail(f"channel_moments {tag} did not take design {plan.design}: "
             f"{before} -> {designs}")
    same_bits(torch, f"channel_moments {tag}", got, again)
    xf = x.float()
    return max(column_sum_close(
        torch, f"channel_moments {tag} {i}", a, w, t)
        for i, (a, w, t) in enumerate(zip(
            got, want, (xf.abs().mean(0), (xf * xf).mean(0))))), plan


def check_ssa_bwd(torch, tag, x, gr, scale, shift, act, design):
    """Kernel 3 launched twice on the design ssa_bwd_design picks: that
    design taken, the same bits twice, and the plain version matched (dx
    elementwise, dscale and dshift as column sums). Returns max |err|."""
    from dcgan_tpu_torch.ops.kernels import scale_shift_act_bwd, \
        scale_shift_act_bwd_plain

    designs = scale_shift_act_bwd.launches_by_design
    before = dict(designs)
    got = scale_shift_act_bwd(x, scale, shift, gr, act)
    again = scale_shift_act_bwd(x, scale, shift, gr, act)
    want = scale_shift_act_bwd_plain(x, scale, shift, gr, act)
    torch.cuda.synchronize()
    if designs != dict(before, **{design: before[design] + 2}):
        fail(f"scale_shift_act_bwd {tag} did not take design {design}: "
             f"{before} -> {designs}")
    same_bits(torch, f"scale_shift_act_bwd {tag}", got, again)
    dt_name = "bfloat16" if x.dtype is torch.bfloat16 else "float32"
    ga, xa = gr.float().abs(), x.float().abs()
    return max(check_close(torch, f"scale_shift_act_bwd {tag} dx",
                           got[0], want[0], dt_name),
               column_sum_close(torch, f"scale_shift_act_bwd {tag} dscale",
                                got[1], want[1], (ga * xa).sum(0)),
               column_sum_close(torch, f"scale_shift_act_bwd {tag} dshift",
                                got[2], want[2], ga.sum(0)))


def check_ssa_fwd(torch, tag, x, scale, shift, acts):
    """Kernel 2 once per act of `acts` on TRAIN_DESIGN's design against its
    plain version. Returns max |err|."""
    from dcgan_tpu_torch.ops.kernels import scale_shift_act, \
        scale_shift_act_plain

    designs = scale_shift_act.launches_by_design
    design = TRAIN_DESIGN["scale_shift_act"]
    dt_name = "bfloat16" if x.dtype is torch.bfloat16 else "float32"
    err = 0.0
    for a in acts:
        before = dict(designs)
        y = scale_shift_act(x, scale, shift, a)
        torch.cuda.synchronize()
        if designs != dict(before, **{design: before[design] + 1}):
            fail(f"scale_shift_act {tag} {a} did not take design {design}: "
                 f"{before} -> {designs}")
        err = max(err, check_close(
            torch, f"scale_shift_act {tag} {a}", y,
            scale_shift_act_plain(x, scale, shift, a), dt_name))
    return err


def check_gbm(torch, tag, p2d, w2d, b, dt):
    """Kernel 4 launched twice on the design its plan (gemm_plan) picks:
    that design taken, the same bits twice, u against the plain product
    (f32 tolerance: u is f32 in both dtypes) and the moments against those
    of the kernel's own u in the compute dtype (column sums: only the
    summation order differs). Returns (max |err|, the plan)."""
    from dcgan_tpu_torch.ops.fused import gemm_bias_moments, \
        gemm_bias_moments_plain, gemm_plan
    from dcgan_tpu_torch.ops.kernels import sm_count

    designs = gemm_bias_moments.launches_by_design
    plan = gemm_plan(p2d, w2d, sm_count(p2d.device))
    before = dict(designs)
    got = gemm_bias_moments(p2d, w2d, b, dt)
    again = gemm_bias_moments(p2d, w2d, b, dt)
    u_want = gemm_bias_moments_plain(p2d, w2d, b, dt)[0]
    torch.cuda.synchronize()
    if designs != dict(before, **{plan.design: before[plan.design] + 2}):
        fail(f"gemm_bias_moments {tag} did not take its plan's design "
             f"{plan.design}: {before} -> {designs}")
    same_bits(torch, f"gemm_bias_moments {tag}", got, again)
    err = check_close(torch, f"gemm_bias_moments {tag} u", got[0], u_want,
                      "float32")
    v = got[0].to(dt).float()
    err = max(err, column_sum_close(
        torch, f"gemm_bias_moments {tag} mean", got[1], v.mean(0),
        v.abs().mean(0)), column_sum_close(
        torch, f"gemm_bias_moments {tag} mean_sq", got[2], (v * v).mean(0),
        (v * v).mean(0)))
    return err, plan


def gbm_operands(torch, cfg, st, dt, g, batch, quant=False):
    """Kernel 4's operands of stage `st` as the step builds them: a
    post-activation map through the (dilated) im2col and the HWIO weights
    reshaped, both through fake_quant_fp8 when `quant`; and a bias.
    Returns (h, p2d, w2d, b)."""
    from dcgan_tpu_torch.ops.activations import act_fwd
    from dcgan_tpu_torch.ops.fused import conv_patches, w_to_gemm
    from dcgan_tpu_torch.ops.layers import fake_quant_fp8

    dev = torch.device("cuda")
    h = act_fwd(torch.rand((batch, st["res"], st["res"], st["in_ch"]),
                           generator=g, device=dev) * 2.0 - 1.0,
                st["act"], cfg.leak).to(dt)
    p2d, _ = conv_patches(h, cfg.kernel_size, 2, st["transpose"])
    w2d = w_to_gemm(0.02 * torch.randn(
        (cfg.kernel_size, cfg.kernel_size, st["in_ch"], st["c"]),
        generator=g, device=dev)).to(dt)
    if quant:
        p2d, w2d = fake_quant_fp8(p2d), fake_quant_fp8(w2d)
    b = torch.rand((st["c"],), generator=g, device=dev) * 0.2 - 0.1
    if tuple(p2d.shape) != (st["m"], st["k"]):
        fail(f"{st['name']}: patches {tuple(p2d.shape)} != "
             f"{(st['m'], st['k'])}")
    return h, p2d, w2d, b


def check_train_kernels(torch, cfg, ssa_entry, ptxas):
    """Phase 2, the training step's kernels: channel_moments (1),
    scale_shift_act's backward (3) and gemm_bias_moments (4) against their
    plain versions at every batch-64 shape of the step, in bf16 and f32,
    each launched twice to show the bits repeat, on the design its plan
    picks; then timed. Kernel 2's forward is also timed at the training
    shapes (into `ssa_entry`). `ptxas` is the build's ptxas reports."""
    import torch.nn.functional as F

    from dcgan_tpu_torch.ops.activations import ACTS, act_fwd
    from dcgan_tpu_torch.ops.fused import conv_patches, gemm_bias_moments, \
        gemm_bias_moments_plain
    from dcgan_tpu_torch.ops.kernels import channel_moments, \
        channel_moments_plain, scale_shift_act, scale_shift_act_bwd, \
        scale_shift_act_bwd_plain, scale_shift_act_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dtypes = (("bfloat16", torch.bfloat16), ("float32", torch.float32))

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    top = cfg.gf_dim * 2 ** (cfg.num_up_layers - 1)
    n0 = BATCH * cfg.base_size ** 2
    stages = train_shapes(cfg, BATCH)

    # ---- kernel 1: channel_moments at G's bn0 [16 B, 512] and every ------
    # ---- epilogue shape (the use_pallas-only route's BN moments) ---------
    k1 = {"name": "channel_moments", "route": "cuda",
          "source": "dcgan_tpu_torch/csrc/channel_moments.cu",
          "replaces": "dcgan_tpu/ops/pallas_kernels.py:80",
          "design": TRAIN_DESIGN["channel_moments"], "shapes": []}
    # (name, N, C, launches per step on the main path, on the use_pallas
    # route without pallas_fused: every BN's moments, G forwarding twice
    # and D three times per step); bn0 and D conv3 share [1024, 512]
    moment_shapes = [("G bn0", n0, top, 2, 2)] + [
        (s["name"], s["m"], s["c"], 0, s["fwd"]) for s in stages]

    # ragged shapes on the scalar design, and bn0 one element off 16-byte
    # alignment
    for dt_name, dt in dtypes:
        for shape, offset in (((37, 70), 0), ((5, 3), 0), ((n0, top), 1)):
            x = at_offset(torch, rand(*shape, lo=-2.0, hi=2.0).to(dt),
                          offset)
            _, plan = check_moments(torch, f"{dt_name} {shape} +{offset}",
                                    x)
            if plan.design != "scalar":
                fail(f"channel_moments {shape} +{offset} plans {plan}")
    log("channel_moments ragged and unaligned shapes match their plain "
        "versions and repeat bitwise on the scalar design")
    errs = {}
    timed = {}
    for name, n, c, per_step, per_step_unfused in moment_shapes:
        for dt_name, dt in dtypes:
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            err, plan = check_moments(torch, f"{name} {dt_name}", x)
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            if plan.design != k1["design"]:
                fail(f"channel_moments {name} {dt_name} plans {plan}")
            log(f"channel_moments {name} [{n}, {c}] {dt_name} matches its "
                f"plain version and repeats bitwise; plan {plan._asdict()}")
            if dt is not torch.bfloat16:
                continue
            e = {"stage": name, "n": n, "c": c, "per_step": per_step,
                 "per_step_unfused": per_step_unfused,
                 "plan": plan._asdict()}
            if (n, c) not in timed:
                t = timed[(n, c)] = {}
                t["ms"], t["call_ms"] = time_ms(
                    torch, lambda: channel_moments(x), 200,
                    label=f"k1 {name}")
                t["plain_ms"], _ = time_ms(
                    torch, lambda: channel_moments_plain(x), 100,
                    label=f"k1 plain {name}")
                t["library_ms"], _ = time_ms(torch, lambda: (
                    x.float().mean(0), (x.float() ** 2).mean(0)), 100,
                    label=f"k1 library {name}")
                t["hbm_ms"], t["ring"] = time_from_hbm(
                    torch, channel_moments, x, 2 * n * c, f"k1 {name}")
                t_bytes, t_ops = moments_bound(n, c, 2)
                t["bound_ms"] = max(t_bytes, t_ops) * 1e3
                t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            e.update(timed[(n, c)])
            k1["shapes"].append(e)
            log(f"channel_moments {name}: {e['ms']:.4f} ms ("
                f"{e['hbm_ms']:.4f} from HBM) vs bound "
                f"{e['bound_ms']:.5f} ms; plain {e['plain_ms']:.4f} ms; "
                f"library {e['library_ms']:.4f} ms")
    k1["bound_by"] = "bytes" if all(e["bound_by"] == "bytes"
                                    for e in k1["shapes"]) else "operations"
    k1["max_abs_err"], k1["max_abs_err_f32"] = errs["bfloat16"], \
        errs["float32"]
    k1.update(entry_report(ptxas, "22moments_cluster_kernelI13__nv_bfloat16"
                                  "Li8E"))
    # the use_pallas route's step (BN moments on kernel 1 at every shape)
    k1["use_pallas_step"] = {
        key: sum(e[key] * e["per_step_unfused"] for e in k1["shapes"])
        for key in ("ms", "hbm_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"channel_moments per step: {weighted(k1['shapes'], 'ms'):.4f} ms "
        f"on the main path (bound "
        f"{weighted(k1['shapes'], 'bound_ms'):.5f}), "
        f"{k1['use_pallas_step']['ms']:.4f} ms on the use_pallas route "
        f"({k1['use_pallas_step']['hbm_ms']:.4f} from HBM; bound "
        f"{k1['use_pallas_step']['bound_ms']:.5f})")

    # ---- kernels 3 and 2 at every BN epilogue of the step ----------------
    k3 = {"name": "scale_shift_act_bwd", "route": "cuda",
          "source": "dcgan_tpu_torch/csrc/scale_shift_act.cu",
          "replaces": "dcgan_tpu/ops/pallas_kernels.py:180",
          "design": TRAIN_DESIGN["scale_shift_act_bwd"], "shapes": []}
    epilogues = [("G bn0", n0, top, "relu", 2, 1)] + [
        (s["name"], s["m"], s["c"], s["act"], s["fwd"], s["bwd"])
        for s in stages]

    # ragged shapes, every activation: C 70 (not a multiple of the 16-byte
    # width) and C 72 at a pointer one element off 16 bytes on the scalar
    # design, C 72 aligned on the vector design (37 rows: a ragged last
    # step); f32 C 70 is not a multiple of 4 either
    for act in ACTS:
        for dt_name, dt in dtypes:
            for c, offset, design in ((70, 0, "scalar"), (72, 0, "vector"),
                                      (72, 1, "scalar")):
                x = at_offset(torch, rand(37, c, lo=-2.0, hi=2.0).to(dt),
                              offset)
                gr = at_offset(torch, rand(37, c).to(dt), offset)
                scale, shift = rand(c, lo=0.5, hi=1.5), rand(c)
                check_ssa_bwd(torch,
                              f"ragged {dt_name} [37, {c}] +{offset} {act}",
                              x, gr, scale, shift, act, design)
    log("scale_shift_act_bwd ragged shapes match their plain versions and "
        "repeat bitwise on designs scalar (C 70; C 72 off 16-byte "
        "alignment) and vector (C 72), every act, bf16 and f32")
    fwd_shapes = []
    errs = {}
    for name, n, c, act, fwd, bwd in epilogues:
        for dt_name, dt in dtypes:
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            gr = rand(n, c).to(dt)
            scale, shift = rand(c, lo=0.5, hi=1.5), rand(c, lo=-0.5, hi=0.5)
            err = check_ssa_bwd(torch, f"{name} {dt_name}", x, gr, scale,
                                shift, act, k3["design"])
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            # kernel 2 at this epilogue's shape, every act, on its design
            k2_err = check_ssa_fwd(torch, f"{name} {dt_name}", x, scale,
                                   shift, ACTS)
            key = "max_abs_err" if dt is torch.bfloat16 \
                else "max_abs_err_f32"
            ssa_entry[key] = max(ssa_entry[key], k2_err)
            log(f"scale_shift_act {name} [{n}, {c}] {dt_name} takes design "
                f"{TRAIN_DESIGN['scale_shift_act']} and matches its plain "
                f"version at every act (max |err| {k2_err:.3g})")
            if dt is not torch.bfloat16:
                continue
            e = {"stage": name, "n": n, "c": c, "per_step": bwd,
                 "design": k3["design"]}
            e["ms"], e["call_ms"] = time_ms(torch, lambda: scale_shift_act_bwd(
                x, scale, shift, gr, act), 50, label=f"k3 {name}")
            e["plain_ms"], _ = time_ms(
                torch, lambda: scale_shift_act_bwd_plain(
                    x, scale, shift, gr, act), 20, label=f"k3 plain {name}")
            # the library yardstick: torch's own autograd of the expression
            xl, sl, tl = (x.detach().requires_grad_(True),
                          scale.detach().requires_grad_(True),
                          shift.detach().requires_grad_(True))
            lib_act = F.relu if act == "relu" else \
                (lambda v: F.leaky_relu(v, cfg.leak))
            y = lib_act(xl.float() * sl + tl).to(dt)
            e["library_ms"], _ = time_ms(torch, lambda: torch.autograd.grad(
                y, (xl, sl, tl), gr, retain_graph=True), 20,
                label=f"k3 library {name}")
            del y
            t_bytes, t_ops = ssa_bwd_bound(n, c, 2)
            e["bound_ms"] = max(t_bytes, t_ops) * 1e3
            e["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            k3["shapes"].append(e)
            # kernel 2, the same epilogue's forward, at the training shape
            f = {"stage": name, "n": n, "c": c, "per_step": fwd,
                 "design": TRAIN_DESIGN["scale_shift_act"]}
            f["ms"], _ = time_ms(torch, lambda: scale_shift_act(
                x, scale, shift, act), 50, label=f"k2 {name}")
            f["plain_ms"], _ = time_ms(torch, lambda: scale_shift_act_plain(
                x, scale, shift, act), 20, label=f"k2 plain {name}")
            f["library_ms"], _ = time_ms(torch, lambda: act_fwd(
                x.float() * scale + shift, act, cfg.leak).to(dt), 20,
                label=f"k2 library {name}")
            f["hbm_ms"], f["ring"] = time_from_hbm(
                torch, lambda xi: scale_shift_act(xi, scale, shift, act), x,
                2 * 2 * n * c, f"k2 {name}")
            # what the card's own copy of the same bytes takes from HBM: the
            # rate one launch of this size can reach
            f["copy_hbm_ms"], _ = time_from_hbm(
                torch, torch.clone, x, 2 * 2 * n * c, f"k2 copy {name}")
            tb, to = ssa_bound(n, c)
            f["bound_ms"] = max(tb, to) * 1e3
            fwd_shapes.append(f)
            log(f"scale_shift_act {name} [{n}, {c}] {act}: {f['ms']:.4f} ms "
                f"({f['hbm_ms']:.4f} from HBM, a copy of its bytes "
                f"{f['copy_hbm_ms']:.4f}) vs bound {f['bound_ms']:.5f} ms; "
                f"plain "
                f"{f['plain_ms']:.4f} ms; library {f['library_ms']:.4f} ms")
        log(f"scale_shift_act_bwd {name} [{n}, {c}] {act} matches its plain "
            f"version and repeats bitwise; {k3['shapes'][-1]['ms']:.4f} ms "
            f"vs bound {k3['shapes'][-1]['bound_ms']:.5f} ms")
    k3["max_abs_err"], k3["max_abs_err_f32"] = errs["bfloat16"], \
        errs["float32"]
    k3["bound_by"] = "bytes" if all(e["bound_by"] == "bytes"
                                    for e in k3["shapes"]) else "operations"
    ssa_entry["train_step"] = {
        key: weighted(fwd_shapes, key)
        for key in ("ms", "hbm_ms", "copy_hbm_ms", "plain_ms", "library_ms",
                    "bound_ms")}
    ssa_entry["train_step"]["shapes"] = fwd_shapes
    step_launches = sum(f["per_step"] for f in fwd_shapes)
    log(f"scale_shift_act per training step ({step_launches} launches): "
        f"{ssa_entry['train_step']['ms']:.4f} ms ("
        f"{ssa_entry['train_step']['hbm_ms']:.4f} from HBM) vs bound "
        f"{ssa_entry['train_step']['bound_ms']:.4f} ms; plain "
        f"{ssa_entry['train_step']['plain_ms']:.4f} ms; library "
        f"{ssa_entry['train_step']['library_ms']:.4f} ms")

    # ---- kernel 4: gemm_bias_moments at every fused stage ----------------
    k4 = {"name": "gemm_bias_moments", "route": "cuda",
          "source": "dcgan_tpu_torch/csrc/gemm_bias_moments.cu",
          "replaces": "dcgan_tpu/ops/pallas_fused.py:144",
          "design": TRAIN_DESIGN["gemm_bias_moments"], "shapes": []}

    # ragged M and C: an aligned shape on v2 (a partial row tile, C 72 in a
    # 128-column tile), then K 37 / C 70 and the aligned shape one element
    # off 16-byte alignment on v1, and f32 on SIMT
    for m, k, c, dt, offset, design in (
            (1000, 200, 72, torch.bfloat16, 0, "v2"),
            (100, 37, 70, torch.bfloat16, 0, "v1"),
            (1000, 200, 72, torch.bfloat16, 1, "v1"),
            (100, 37, 70, torch.float32, 0, "simt")):
        p = at_offset(torch, rand(m, k).to(dt), offset)
        w = at_offset(torch, (0.1 * rand(k, c)).to(dt), offset)
        b = rand(c, lo=-0.1, hi=0.1)
        tag = f"ragged {(m, k, c)} +{offset} {str(dt)[6:]}"
        _, plan = check_gbm(torch, tag, p, w, b, dt)
        if plan.design != design:
            fail(f"gemm_bias_moments {tag} plans {plan.design}, not {design}")
    log("gemm_bias_moments ragged shapes match their plain versions and "
        "repeat bitwise on designs v2, v1 (K 37 / C 70; an unaligned "
        "pointer) and simt")
    errs = {}
    for st in stages:
        name, m, k, c = st["name"], st["m"], st["k"], st["c"]
        e = {"stage": name, "m": m, "k": k, "c": c, "per_step": st["fwd"]}
        for dt_name, dt in dtypes:
            h, p2d, w2d, b = gbm_operands(torch, cfg, st, dt, g, BATCH)
            err, plan = check_gbm(torch, f"{name} {dt_name}", p2d, w2d, b,
                                  dt)
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            if dt is torch.bfloat16:
                if plan.design != k4["design"]:
                    fail(f"gemm_bias_moments {name}: the bf16 stage plans "
                         f"design {plan.design}, not {k4['design']}")
                e["plan"] = plan._asdict()
                e.update(gbm_entry_report(ptxas, plan.bn))
                e["ms"], e["call_ms"] = time_ms(
                    torch, lambda: gemm_bias_moments(p2d, w2d, b, dt), 20,
                    label=f"k4 {name}")
                e["plain_ms"], _ = time_ms(
                    torch, lambda: gemm_bias_moments_plain(p2d, w2d, b, dt),
                    10, label=f"k4 plain {name}")

                def library():
                    u = torch.matmul(p2d, w2d).float() + b
                    vv = u.to(dt).float()
                    return u, vv.mean(0), (vv * vv).mean(0)
                e["library_ms"], _ = time_ms(torch, library, 20,
                                             label=f"k4 library {name}")
                # the im2col that feeds the kernel in the step
                e["im2col_ms"], _ = time_ms(torch, lambda: conv_patches(
                    h, cfg.kernel_size, 2, st["transpose"]), 10,
                    label=f"im2col {name}")
                t_bytes, t_ops = gbm_bound(m, k, c, 2)
                e["bound_ms"] = max(t_bytes, t_ops) * 1e3
                e["bound_by"] = "bytes" if t_bytes >= t_ops \
                    else "operations"
            del h, p2d, w2d
            torch.cuda.empty_cache()
        log(f"gemm_bias_moments {name} M={m} K={k} C={c} matches its plain "
            f"version and repeats bitwise; bf16 plan {e['plan']} "
            f"({e['registers']} registers, {e['spill_bytes']} B spilled); "
            f"{e['ms']:.4f} ms vs bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}); library {e['library_ms']:.4f} ms; plain "
            f"{e['plain_ms']:.4f} ms; its im2col {e['im2col_ms']:.4f} ms")
        k4["shapes"].append(e)
    k4["max_abs_err"], k4["max_abs_err_f32"] = errs["bfloat16"], \
        errs["float32"]
    k4["bound_by"] = "bytes" if all(e["bound_by"] == "bytes"
                                    for e in k4["shapes"]) else "operations"
    k4["im2col_ms"] = weighted(k4["shapes"], "im2col_ms")
    k4["registers"] = max(e["registers"] for e in k4["shapes"])
    k4["spill_bytes"] = max(e["spill_bytes"] for e in k4["shapes"])

    # per training step at batch 64: the launch-weighted sums
    for entry in (k1, k3, k4):
        for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
            entry[key] = weighted(entry["shapes"], key)
    return [k1, k3, k4]


def calibrated_weights(torch, np, cfg):
    """Seeded params with BN running statistics set from one batch through
    the plain route, then perturbed by numpy noise, so every stage's scale
    and shift are nontrivial and activations stay O(1)."""
    from dcgan_tpu_torch.models.dcgan import generator_init, torch_dtype
    from dcgan_tpu_torch.ops.layers import deconv2d_apply, linear_apply
    from dcgan_tpu_torch.ops.norm import batch_norm_apply

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    params, state = generator_init(cfg, seed=SEED, device=dev)

    def noise(shape, scale):
        return torch.from_numpy(
            rng.normal(0.0, scale, shape).astype(np.float32)).to(dev)

    for name, p in params.items():
        if name.startswith("deconv"):
            p["b"] = noise(p["b"].shape, 0.02)
        elif name.startswith("bn"):
            p["bias"] = noise(p["bias"].shape, 0.1)
    k = cfg.num_up_layers
    cdt = torch_dtype(cfg.compute_dtype)
    z = torch.from_numpy(rng.uniform(-1, 1, (BATCH, cfg.z_dim))
                         .astype(np.float32)).to(dev)
    with torch.inference_mode():
        h = linear_apply(params["proj"], z.to(cdt), compute_dtype=cdt)
        h = h.reshape(BATCH, cfg.base_size, cfg.base_size, -1)
        for i in range(k):
            if i:
                h = deconv2d_apply(params[f"deconv{i}"], h,
                                   compute_dtype=cdt)
            hf = h.float().reshape(-1, h.shape[-1])
            c = hf.shape[1]
            mean = hf.mean(0) * (1.0 + noise((c,), 0.1))
            var = hf.var(0, unbiased=False) * torch.from_numpy(
                rng.uniform(0.8, 1.25, c).astype(np.float32)).to(dev)
            state[f"bn{i}"] = {"mean": mean.clone(), "var": var.clone()}
            h, _ = batch_norm_apply(params[f"bn{i}"], state[f"bn{i}"], h,
                                    train=False, eps=cfg.bn_eps, act="relu")
    return params, state


def check_served(torch, np, cfg, path, row, responses):
    """The serve report and responses of one demo load: every request
    completed, finite float32 images in [-1, 1] of the model's shape, the
    first four equal to direct sampler calls on their z rows. Returns the
    reloaded (params, state)."""
    from dcgan_tpu_torch.convert import load_weights
    from dcgan_tpu_torch.models.dcgan import sampler_apply

    if row["completed"] != N_REQUESTS or row["serve/dropped"] != 0:
        fail(f"served {row['completed']}/{N_REQUESTS} requests, "
             f"{row['serve/dropped']} dropped")
    size = cfg.output_size
    for i, r in enumerate(responses):
        img = r.result(timeout=0)
        n = img.shape[0]
        if img.shape != (n, size, size, cfg.c_dim) or img.dtype != np.float32:
            fail(f"request {i}: images {img.shape} {img.dtype}")
        if not np.isfinite(img).all() or np.abs(img).max() > 1.0:
            fail(f"request {i}: images not finite or outside [-1, 1]")
    log(f"{len(responses)} responses: finite float32 [n, {size}, {size}, "
        f"{cfg.c_dim}] in [-1, 1]")

    # the served rows are the sampler's on the request's own z rows (the
    # server draws z per request from numpy's default_rng((seed, serial)))
    cfg_l, params_l, state_l = load_weights(path, device="cuda")
    if cfg_l != cfg:
        fail("config.json round trip changed the config")
    worst = 0.0
    for serial, r in enumerate(responses[:4]):
        n = r.images.shape[0]
        z = np.random.default_rng((SEED, serial)).uniform(
            -1.0, 1.0, (n, cfg.z_dim)).astype(np.float32)
        direct = sampler_apply(params_l, state_l, torch.from_numpy(z).cuda(),
                               cfg=cfg).cpu().numpy()
        worst = max(worst, float(np.abs(direct - r.images).max()))
    if worst > SERVED_TOL:
        fail(f"served images differ from a direct sampler call by {worst}")
    log(f"served images match direct sampler calls (max |err| {worst:.3g} "
        f"<= {SERVED_TOL})")
    return params_l, state_l


def serve_and_check(torch, np, cfg, workdir, kernels):
    """Phases 3 and 4."""
    from dcgan_tpu_torch.convert import save_weights
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve import __main__ as serve_main

    params, state = calibrated_weights(torch, np, cfg)
    path = save_weights(os.path.join(workdir, "celeba64.npz"), cfg, params,
                        state)
    report_path = os.path.join(workdir, "serve_report.json")
    wrappers = all_wrappers()
    served = ("scale_shift_act", "gemm_bias_scale_act")

    by_design = wrappers["gemm_bias_scale_act"].launches_by_design
    reset_counts(wrappers)
    with served_batches(np) as batches:
        row, responses = serve_main.run([
            "--weights", path, "--device", "cuda", "--max_batch",
            str(BATCH), "--demo_requests", str(N_REQUESTS), "--demo_rps",
            "500", "--demo_max_images", "8", "--seed", str(SEED),
            "--report", report_path])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"served path gemm_bias_scale_act launches by design: {by_design}")
    if by_design[GBSA_DESIGN] != launches["gemm_bias_scale_act"]:
        fail(f"the served bf16 stages must all launch the {GBSA_DESIGN} "
             f"gemm_bias_scale_act kernel: {by_design}")
    ssa_designs = wrappers["scale_shift_act"].launches_by_design
    log(f"served path scale_shift_act launches by design: {ssa_designs}")
    design = TRAIN_DESIGN["scale_shift_act"]
    if ssa_designs[design] != launches["scale_shift_act"]:
        fail(f"the served scale_shift_act launches must all take design "
             f"{design}: {ssa_designs}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["serve"] = \
            launches[entry["name"]]
    log(f"served path launches: {launches}")
    for name in served:
        if launches[name] < 1:
            fail(f"kernel {name} was not launched on the served path")

    params_l, state_l = check_served(torch, np, cfg, path, row, responses)
    check_captured_serving(torch, np, "celeba64 serve", row, batches)

    # the kernel route against the cuDNN + torch-BN route, same weights
    z = torch.from_numpy(np.random.default_rng(SEED + 2).uniform(
        -1.0, 1.0, (BATCH, cfg.z_dim)).astype(np.float32)).cuda()
    for dt_name in ("bfloat16", "float32"):
        fused = dataclasses.replace(cfg, compute_dtype=dt_name)
        plain = dataclasses.replace(fused, use_pallas=False,
                                    pallas_fused=False)
        a = sampler_apply(params_l, state_l, z, cfg=fused)
        b = sampler_apply(params_l, state_l, z, cfg=plain)
        err = float((a - b).abs().max())
        spread = float(b.std())
        if not bool(torch.isfinite(a).all()) or err > ROUTE_TOL[dt_name]:
            fail(f"kernel route vs cuDNN route ({dt_name}): max |err| {err}"
                 f" > {ROUTE_TOL[dt_name]}")
        log(f"kernel route matches the cuDNN + torch-BN route in {dt_name} "
            f"at batch {BATCH} (max |err| {err:.3g} <= "
            f"{ROUTE_TOL[dt_name]}; output std {spread:.3f})")

    # one whole sampler call at the top bucket, on each route (bf16)
    plain = dataclasses.replace(cfg, use_pallas=False, pallas_fused=False)
    timing = {"batch": BATCH}
    for name, route in (("kernel_route", cfg), ("cudnn_route", plain)):
        timing[f"{name}_ms"], timing[f"{name}_call_ms"] = time_ms(
            torch, lambda: sampler_apply(params_l, state_l, z, cfg=route), 20,
            label=f"sampler {name}")
    log(f"sampler at batch {BATCH}: kernel route "
        f"{timing['kernel_route_ms']:.4f} ms, cuDNN + torch-BN route "
        f"{timing['cudnn_route_ms']:.4f} ms (device); host-inclusive "
        f"{timing['kernel_route_call_ms']:.4f} / "
        f"{timing['cudnn_route_call_ms']:.4f} ms")
    return row, timing


def grad_gaps(convert, got, want, rtol, atol):
    """Leaf -> |got - want| / (rtol * |want| + atol * the net's largest
    leaf norm), norms over the leaf; the gradients agree where every gap
    is <= 1."""
    gaps = {}
    for net in ("gen", "disc"):
        g, w = convert.flatten(got[net]), convert.flatten(want[net])
        top = max(float(x.norm()) for x in w.values())
        for path, x in w.items():
            gaps[f"{net}/{path}"] = float((g[path] - x).norm()) / (
                rtol * float(x.norm()) + atol * top)
    return gaps


def broken_backwards(dt_name):
    """(name, patch) pairs, each breaking one backward on purpose, that the
    gradient comparison in `dt_name` must catch: a patch is a context
    manager that swaps an autograd.Function's backward for the run."""
    import contextlib

    from dcgan_tpu_torch.ops import fused, kernels

    @contextlib.contextmanager
    def swap(fn_cls, make):
        orig = fn_cls.backward
        fn_cls.backward = staticmethod(make(orig))
        try:
            yield
        finally:
            fn_cls.backward = staticmethod(orig)

    def dscale_times(f):
        def make(orig):
            def bwd(ctx, g):
                dx, dscale, *rest = orig(ctx, g)
                return (dx, dscale * f, *rest)
            return bwd
        return swap(kernels._ScaleShiftAct, make)

    def moments_cotangent_dropped(fn_cls):
        def make(orig):
            def bwd(ctx, *cotangents):
                g_msq = cotangents[-1]
                return orig(ctx, *cotangents[:-1], g_msq * 0)
            return bwd
        return swap(fn_cls, make)

    if dt_name == "bfloat16":
        return [("scale_shift_act_bwd dscale zeroed", dscale_times(0.0)),
                ("gemm_bias_moments E[u^2] cotangent dropped",
                 moments_cotangent_dropped(fused._GemmBiasMoments))]
    return [("scale_shift_act_bwd dscale 2 % off", dscale_times(1.02)),
            ("channel_moments E[x^2] cotangent dropped",
             moments_cotangent_dropped(kernels._ChannelMoments))]


def all_wrappers():
    from dcgan_tpu_torch.graphs import kernel_wrappers

    return kernel_wrappers()


def device_op(e):
    """A profiler event of the card's own work: a kernel, copy or set,
    not the device span of a record_function range (the captured
    programs' names, graphs.py), which covers its kernels and the gaps
    between them."""
    return e.device_type.name == "CUDA" and not getattr(
        e, "is_user_annotation", False)


def kernel_totals(prof, settle):
    """[{key, us, count}] of the trace's device kernels by name: every
    kernel (the profiler's key_averages), or with `settle` those that
    start after the last spin kernel ends (the spin left out)."""
    if not settle:
        out = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us and device_op(e):
                out.append({"key": e.key, "us": us, "count": e.count})
        return out
    kernels = [e for e in prof.events() if device_op(e)]
    spins = [e.time_range.end for e in kernels if "spin_kernel" in e.name]
    if not spins:
        fail("profile_split: the trace holds no spin kernel")
    totals = {}
    for e in kernels:
        if e.time_range.start >= max(spins) and "spin_kernel" not in e.name:
            t = totals.setdefault(e.name, {"key": e.name, "us": 0.0,
                                           "count": 0})
            t["us"] += e.time_range.elapsed_us()
            t["count"] += 1
    return [t for t in totals.values() if t["us"]]


def profile_split(torch, fn, steps: int = 3, settle: bool = False):
    """Device time of `steps` calls of fn() by kernel family, from
    torch.profiler's per-kernel self device times, and the share of the
    window the card sat idle. None if the trace holds no device time.

    settle: inside the trace, one call, then a spin kernel that holds the
    card and a wait for it, then the calls; only the kernels that start
    after the spin ends are summed. A graph replay's early kernels went
    missing from traces on the card: without the spin, and in one long
    run with it too (one of the four moments_cluster_kernel launches of
    two celeba64 replays, in each of three traces), so the counted
    replays are no longer a trace's first."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if settle:
            fn()
            torch.cuda._sleep(int(SETTLE_MS * 2e6))
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"flash attention kernels": ("flash_fwd_", "flash_dq_",
                                            "flash_dkv_"),
                "port kernels": ("gbm_", "ssa_", "moments_",
                                 "finish_column_partials", "gbsa_"),
                "library GEMM and conv": ("gemm", "cutlass", "sm90_",
                                          "xmma", "conv", "cudnn", "cublas",
                                          "wgrad", "dgrad", "implicit"),
                "im2col backward (unfold_backward)": ("unfold",)}
    split = {name: 0.0 for name in families}
    split["other (elementwise, copies, reductions)"] = 0.0
    flash, port = {}, {}
    top = []
    for e in kernel_totals(prof, settle):
        ms = e["us"] / 1e3 / steps
        top.append((ms, e["count"] / steps, e["key"][:120]))
        key = e["key"].lower()
        m = re.search(r"flash_\w+_kernel(<[^>]*>)?", e["key"])
        if m:
            f = flash.setdefault(m.group(0), {"ms": 0.0, "calls": 0.0})
            f["ms"] += ms
            f["calls"] += e["count"] / steps
        for name, marks in families.items():
            if any(mark in key for mark in marks):
                split[name] += ms
                if name == "port kernels":
                    # the entry's name without namespace or parameters
                    m = re.search(r"(\w+)(<[^>]*>)?\(", e["key"])
                    f = port.setdefault(m.group(0)[:-1] if m else e["key"],
                                        {"ms": 0.0, "calls": 0.0})
                    f["ms"] += ms
                    f["calls"] += e["count"] / steps
                break
        else:
            split["other (elementwise, copies, reductions)"] += ms
    busy = sum(split.values())
    if busy <= 0.0:
        return None
    top.sort(reverse=True)
    return {"ms_per_step": split, "flash_by_kernel": flash,
            "port_by_kernel": port, "busy_ms": busy,
            "launches_per_step": sum(n for _, n, _ in top),
            "wall_ms": wall_ms / steps,
            "idle_share": max(0.0, 1.0 - busy / (wall_ms / steps)),
            "top_kernels": [{"ms": ms, "calls": n, "name": name}
                            for ms, n, name in top[:15]]}


def read_events(np, directory, train_s):
    """The trainer's events.jsonl: one scalars event per step with finite
    losses. Returns the last event's values."""
    with open(os.path.join(directory, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    if [e["step"] for e in events] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"events.jsonl steps {[e['step'] for e in events]}")
    for e in events:
        vals = [e["values"][k] for k in ("d_loss", "d_loss_real",
                                         "d_loss_fake", "g_loss")]
        if e["kind"] != "scalars" or not all(np.isfinite(vals)):
            fail(f"step {e['step']}: losses {vals}")
    last = events[-1]["values"]
    log(f"trained {TRAIN_STEPS} steps in {train_s:.1f} s (first step "
        f"included); last d_loss {last['d_loss']:.5f} g_loss "
        f"{last['g_loss']:.5f}, steady step "
        f"{last.get('perf/step_ms_mean', float('nan')):.2f} ms host clock")
    return last


def train_and_check(torch, np, workdir, kernels):
    """Phases 5 and 6: the trainer's entry point on cuda, launches read
    around it, then the route comparison and timings of one step."""
    import dataclasses as dc

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.data.synthetic import synthetic_batches
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.steps import init_train_state, make_train_step

    tdir = os.path.join(workdir, "celeba64_train")
    argv = ["--preset", "celeba64", "--use_pallas", "--pallas_fused",
            "--synthetic", "--max_steps", str(TRAIN_STEPS),
            "--batch_size", str(BATCH), "--device", "cuda",
            "--checkpoint_dir", tdir, "--seed", str(SEED)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"train path launches over {TRAIN_STEPS} steps: {launches}")
    for name, per_step in PER_STEP.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"kernel {name}: {launches[name]} launches on the train "
                 f"path, expected {per_step} per step x {TRAIN_STEPS}")
    # every launch of kernels 4 and 3 on the bf16 step took its Hopper
    # design
    for name, design in TRAIN_DESIGN.items():
        by_design = wrappers[name].launches_by_design
        log(f"train path {name} launches by design: {by_design}")
        if by_design[design] != launches[name]:
            fail(f"the train path's {name} launches must all take design "
                 f"{design}: {by_design}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["train"] = \
            launches[entry["name"]]

    last = read_events(np, tdir, train_s)

    # every parameter and BN running statistic moved from the seeded init
    init = init_train_state(cfg, device="cuda")
    for group in ("params", "bn"):
        for net in ("gen", "disc"):
            after = convert.flatten(state[group][net])
            for path, a in convert.flatten(init[group][net]).items():
                if torch.equal(a, after[path]):
                    fail(f"{group}/{net}/{path} did not move in "
                         f"{TRAIN_STEPS} steps")
    if int(state["step"]) != TRAIN_STEPS:
        fail(f"state step {int(state['step'])} != {TRAIN_STEPS}")
    log("every parameter and BN running statistic moved from the init")

    # from the seeded state, kernel route vs cuDNN + torch-BN route on the
    # same images and z: the losses, and every leaf's gradient for both
    # nets (those the fused update mode applies), so that the kernels'
    # backward is held against the library's and not only the forward
    images = torch.from_numpy(next(synthetic_batches(
        BATCH, cfg.model.output_size, cfg.model.c_dim,
        seed=SEED + 3))).cuda()
    z = torch.rand((BATCH, cfg.model.z_dim), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(
                       SEED + 4)) * 2.0 - 1.0
    report = {"steps": TRAIN_STEPS, "batch": BATCH, "train_s": train_s,
              "last_losses": {k: last[k] for k in ("d_loss", "g_loss")},
              "launches": launches}
    steps_by_route = {}
    for dt_name in ("bfloat16", "float32"):
        losses, grads = {}, {}
        for route, flags in (("kernel", {}),
                             ("cudnn", {"use_pallas": False,
                                        "pallas_fused": False})):
            rcfg = dc.replace(cfg, model=dc.replace(
                cfg.model, compute_dtype=dt_name, **flags))
            fns = make_train_step(rcfg)
            grads[route], metrics = fns.grads(init, images, z)
            losses[route] = {k: float(v) for k, v in metrics.items()}
            if dt_name == "bfloat16":
                steps_by_route[route] = fns.train_step
        rtol, atol = TRAIN_ROUTE_TOL[dt_name]
        err = max(abs(losses["kernel"][k] - losses["cudnn"][k])
                  for k in losses["kernel"])
        bad = [k for k in losses["kernel"]
               if abs(losses["kernel"][k] - losses["cudnn"][k])
               > rtol * abs(losses["cudnn"][k]) + atol]
        if not all(np.isfinite(list(losses["kernel"].values()))) or bad:
            fail(f"train losses, kernel route vs cuDNN route ({dt_name}): "
                 f"losses {losses}, outside rtol={rtol} atol={atol}: {bad}")
        report[f"route_err_{dt_name}"] = err
        log(f"train losses, kernel route vs cuDNN + torch-BN route in "
            f"{dt_name}: max |err| {err:.3g} within rtol={rtol} atol={atol} "
            f"({losses['kernel']} vs {losses['cudnn']})")

        rtol, atol = TRAIN_GRAD_TOL[dt_name]
        gaps = grad_gaps(convert, grads["kernel"], grads["cudnn"], rtol,
                         atol)
        bad = {k: v for k, v in gaps.items() if not v <= 1.0}
        if bad:
            fail(f"train gradients, kernel route vs cuDNN route "
                 f"({dt_name}), outside rtol={rtol} atol={atol}, gap / "
                 f"limit: {bad}")
        worst = max(gaps, key=gaps.get)
        report[f"grad_gap_{dt_name}"] = gaps[worst]
        log(f"train gradients, kernel route vs cuDNN + torch-BN route in "
            f"{dt_name}: {len(gaps)} leaves within rtol={rtol} "
            f"atol={atol} x the net's largest leaf norm; the closest to "
            f"its limit is {worst} at {gaps[worst]:.3g} of it")
        # the comparison must fail a backward that is broken on purpose
        kernel_fns = make_train_step(dc.replace(cfg, model=dc.replace(
            cfg.model, compute_dtype=dt_name)))
        for name, patch in broken_backwards(dt_name):
            with patch:
                broken, _ = kernel_fns.grads(init, images, z)
            gaps = grad_gaps(convert, broken, grads["cudnn"], rtol, atol)
            worst = max(gaps, key=gaps.get)
            if not gaps[worst] > 1.0:
                fail(f"train gradients ({dt_name}): a broken backward "
                     f"({name}) stays within the limits (largest gap "
                     f"{gaps[worst]:.3g} of the limit, at {worst})")
            report.setdefault("broken_backward_gap", {})[
                f"{name} ({dt_name})"] = gaps[worst]
            log(f"broken backward caught in {dt_name}: {name}, {worst} at "
                f"{gaps[worst]:.3g} of its limit")

    for route, step in steps_by_route.items():
        # host-device synchronizations inside one step (each stalls the
        # host until the card drains, so the step cannot run ahead)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(init, images, z)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing" in str(w.message)]
        report[f"{route}_step_syncs"] = len(syncs)
        log(f"{route} route step: {len(syncs)} host-device "
            f"synchronization(s) {syncs[:3]}")
        # host-inclusive only: a step queues more launches than the
        # stream's launch queue holds, so a spin-held event pair would
        # still read the host's enqueue rate; the device time is the
        # profiled kernel time below
        _, report[f"{route}_step_call_ms"] = time_ms(
            torch, lambda: step(init, images, z), 5, warmup=1,
            label=f"{route} step")
    for route, step in steps_by_route.items():
        split = profile_split(torch, lambda: step(init, images, z))
        report[f"{route}_profile"] = split if split is not None \
            else "not measured (no device time in the trace)"
        if split is not None:
            log(f"{route} route step, device ms by family "
                f"{ {k: round(v, 4) for k, v in split['ms_per_step'].items()} }"
                f", {split['launches_per_step']:.0f} kernel launches, idle "
                f"share {split['idle_share']:.3f}")
            for name, f in sorted(split["port_by_kernel"].items()):
                log(f"{route} route step, port kernel {name}: "
                    f"{f['ms']:.4f} ms in {f['calls']:.0f} launches")
    busy = {route: report[f"{route}_profile"]["busy_ms"]
            if isinstance(report[f"{route}_profile"], dict) else float("nan")
            for route in steps_by_route}
    log(f"one bf16 train step at batch {BATCH}: kernel route "
        f"{busy['kernel']:.3f} ms, cuDNN + torch-BN route "
        f"{busy['cudnn']:.3f} ms (profiled device busy); host-inclusive "
        f"{report['kernel_step_call_ms']:.3f} / "
        f"{report['cudnn_step_call_ms']:.3f} ms")
    return report


# ---------------------------------------------------------------------------
# sagan64: flash attention kernels 6-8, training, serving
# ---------------------------------------------------------------------------

FLASH_SOURCE = "dcgan_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "dcgan_tpu/ops/pallas_attention.py:166",
                  "flash_dq": "dcgan_tpu/ops/pallas_attention.py:293",
                  "flash_dkv": "dcgan_tpu/ops/pallas_attention.py:308"}
# (B, S, d_qk, d_v): sagan64's attention in both nets, then a ragged S, the
# d_qk 16 instantiation, S one past a 128-key tile, and rows of 24 and 72
# bytes (the bf16 kernels' scalar load path)
FLASH_SHAPES = [(BATCH, 1024, 8, 32), (2, 100, 8, 32), (3, 100, 16, 32),
                (2, 129, 8, 32), (2, 100, 12, 36)]
# sagan128's and sagan256-lc's attention: launched at batch 64 and held
# against the plain version over the first FLASH_ROWS rows of the batch
FLASH_LONG = (4096, 16384)
FLASH_ROWS = 2
# Which design each bf16 kernel is (v1: tiles staged through shared memory
# by elementwise loads, p and ds through shared memory; v2: cp.async tiles,
# p and ds in registers, exp2)
FLASH_DESIGN = {"flash_fwd": "v2", "flash_dq": "v2", "flash_dkv": "v2"}
# the bf16 kernel of each on the sagan64 path: a part of its mangled name
# (flash_fwd_kernel<16, 32>, flash_dq_kernel<16, 32, bf16>,
# flash_dkv_kernel<16, 32, bf16>; the <..., float> instantiations write
# f32 gradients, the spatial group's)
FLASH_ENTRIES = {"flash_fwd": "16flash_fwd_kernelILi16ELi32E",
                 "flash_dq": "15flash_dq_kernelILi16ELi32E13__nv_bfloat16E",
                 "flash_dkv":
                     "16flash_dkv_kernelILi16ELi32E13__nv_bfloat16E"}


def flash_bound(name, b, s, dk, dv, itemsize):
    """(least seconds, what bounds them) for one launch: the largest of
    the bytes each input and output needs once over HBM, the products
    over the tensor-core rate (bf16) or the f32 rate, and one
    exponential per score over the MUFU rate."""
    scores = float(b) * s * s
    rate = BF16_TENSOR_FLOPS if itemsize == 2 else F32_FLOPS
    rows = itemsize * b * s
    if name == "flash_fwd":
        bytes_ = rows * (2 * dk + dv) + 4 * b * s * (dv + 1)
        products = 2.0 * scores * (dk + dv)
    elif name == "flash_dq":
        bytes_ = rows * (3 * dk + 2 * dv) + 8 * b * s
        products = 2.0 * scores * (2 * dk + dv)
    else:
        bytes_ = rows * (3 * dk + 3 * dv) + 8 * b * s
        products = 2.0 * scores * (2 * dk + 2 * dv)
    times = {"bytes": bytes_ / HBM_BYTES_PER_S,
             "products": products / rate,
             "exponentials": scores / EXP_PER_S}
    by = max(times, key=times.get)
    return times[by], by


def flash_close(torch, name, got, want, bound):
    """max |got - want|; fails where it is beyond `bound` (plus one bf16
    ulp of the value for a bf16 output)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite kernel output")
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * w.abs()
    err = (g - w).abs()
    bad = err > bound
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} element(s) beyond the bound; max "
             f"|err| {float(err.max()):.3g}")
    return float(err.max())


def flash_round(torch, q, k, v, gout, scale, rows=None):
    """Kernels 6-8 on (q, k, v) against their plain versions on the first
    `rows` rows of the batch (all when None), the backward fed the plain
    forward's lse and (do, delta) from the cotangent `gout`. Each kernel is
    launched twice and must repeat bit for bit. Returns {name: max |err|}
    and the backward's inputs at full batch."""
    from dcgan_tpu_torch.ops import flash_attention as fa

    n = q.shape[0] if rows is None else rows
    out, lse = fa.flash_fwd(q, k, v, scale)
    again = fa.flash_fwd(q, k, v, scale)
    do, delta = fa.bwd_stats(q, out, gout)
    dq = fa.flash_dq(q, k, v, do, lse, delta, scale)
    dkv = fa.flash_dkv(q, k, v, do, lse, delta, scale)
    again += (fa.flash_dq(q, k, v, do, lse, delta, scale),
              *fa.flash_dkv(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    tag = f"{tuple(q.shape)}/{tuple(v.shape)} {str(q.dtype)[6:]}"
    same_bits(torch, f"flash kernels {tag}", (out, lse, dq, *dkv), again)
    del again
    sl = [t[:n] for t in (q, k, v, do, lse, delta)]
    want_out, want_lse = fa.flash_fwd_plain(*sl[:3], scale)
    # bounds: flash_attention.kernel_error_bounds, plus one bf16 ulp of
    # bf16 outputs (flash_close); lse within 1e-5 (1 + |lse|)
    bounds = fa.kernel_error_bounds(*sl, scale)
    errs = {"flash_fwd": max(
        flash_close(torch, f"flash_fwd out {tag}", out[:n], want_out,
                    bounds["out"]),
        flash_close(torch, f"flash_fwd lse {tag}", lse[:n], want_lse,
                    1e-5 * (1.0 + want_lse.abs())))}
    del want_out, want_lse
    errs["flash_dq"] = flash_close(
        torch, f"flash_dq {tag}", dq[:n], fa.flash_dq_plain(*sl, scale),
        bounds["dq"])
    want_dk, want_dv = fa.flash_dkv_plain(*sl, scale)
    errs["flash_dkv"] = max(
        flash_close(torch, f"flash_dkv dk {tag}", dkv[0][:n], want_dk,
                    bounds["dk"]),
        flash_close(torch, f"flash_dkv dv {tag}", dkv[1][:n], want_dv,
                    bounds["dv"]))
    return errs, (do, lse, delta)


def sdpa_kernels(torch, fn):
    """The device kernels one call of fn() ran, costliest first (the
    backend F.scaled_dot_product_attention picked shows in their names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and e.device_type.name == "CUDA":
            rows.append((us, e.key[:100]))
    return [name for _, name in sorted(rows, reverse=True)[:3]]


def time_flash(torch, q, k, v, do, lse, delta, scale, rows, iters):
    """{name: {ms, call_ms, plain_ms, library_ms, library, bound_ms,
    bound_by, bound_kind}} of kernels 6-8 at q's shape (bf16); the plain
    versions timed over the first `rows` rows of the batch; the library
    yardstick is F.scaled_dot_product_attention's forward (row 6) and its
    whole backward, dq, dk and dv in one call (rows 7 and 8)."""
    import torch.nn.functional as F

    from dcgan_tpu_torch.ops import flash_attention as fa

    b, s, dk = q.shape
    dv = v.shape[2]
    sl = [t[:rows] for t in (q, k, v, do, lse, delta)]
    calls = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, scale),
                           lambda: fa.flash_fwd_plain(*sl[:3], scale)),
             "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                              scale),
                          lambda: fa.flash_dq_plain(*sl, scale)),
             "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                                scale),
                           lambda: fa.flash_dkv_plain(*sl, scale))}
    out = {}
    for name, (kernel, plain) in calls.items():
        e = {"shape": [b, s, dk, dv]}
        e["ms"], e["call_ms"] = time_ms(torch, kernel, iters, warmup=1,
                                        label=f"{name} {list(q.shape)}")
        e["plain_ms"], _ = time_ms(torch, plain, max(1, iters // 4),
                                   warmup=1,
                                   label=f"{name} plain {list(q.shape)}")
        if rows != b:
            e["plain_rows"] = rows
        t, kind = flash_bound(name, b, s, dk, dv, q.element_size())
        e["bound_ms"] = t * 1e3
        e["bound_kind"] = kind
        e["bound_by"] = "bytes" if kind == "bytes" else "operations"
        out[name] = e
    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_(True)
                  for t in (q, k, v))
    try:
        def fwd():
            return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        y = fwd()
        g4 = do.unsqueeze(1).to(y.dtype)

        def bwd():
            return torch.autograd.grad(y, (q4, k4, v4), g4,
                                       retain_graph=True)
        lib = {"flash_fwd": (fwd, "forward"), "flash_dq": (bwd, "backward"),
               "flash_dkv": (bwd, "backward")}
        for name, (fn, what) in lib.items():
            with torch.no_grad() if what == "forward" else \
                    contextlib.nullcontext():
                out[name]["library_ms"], _ = time_ms(torch, fn, iters,
                                                     warmup=1,
                                                     label=f"{name} library")
            out[name]["library"] = (
                f"F.scaled_dot_product_attention {what}: "
                f"{sdpa_kernels(torch, fn)}")
        del y
    except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
        for name in out:
            out[name]["library_ms"] = None
            out[name]["library"] = ("F.scaled_dot_product_attention failed: "
                                    f"{str(err).splitlines()[0][:200]}")
    del q4, k4, v4
    torch.cuda.empty_cache()
    return out


def check_flash_kernels(torch, ptxas):
    """Phase 7. Returns the kernels line's entries for kernels 6-8;
    `ptxas` is the build's ptxas reports (`_build.ptxas_report`)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def qkv(b, s, dk, dv, dt):
        q, k, v = (torch.randn((b, s, d), generator=g, device=dev).to(dt)
                   for d in (dk, dk, dv))
        return q, k, v, torch.randn((b, s, dv), generator=g, device=dev)

    entries = {}
    for name in FLASH_REPLACES:
        found = [e for e in ptxas if FLASH_ENTRIES[name] in e["entry"]]
        if len(found) != 1:
            raise RuntimeError(f"{len(found)} ptxas entries match "
                               f"{FLASH_ENTRIES[name]}")
        report = found[0]
        entries[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[name], "design": FLASH_DESIGN[name],
            "registers": report.get("registers"),
            "spill_bytes": (report.get("spill_stores", 0)
                            + report.get("spill_loads", 0)), "long": []}
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        for shape in FLASH_SHAPES:
            b, s, dk, dv = shape
            q, k, v, gout = qkv(b, s, dk, dv, dt)
            errs, bwd_in = flash_round(torch, q, k, v, gout, dk ** -0.5)
            log(f"flash kernels {shape} {dt_name} match their plain "
                f"versions and repeat bitwise (max |err| "
                f"{ {n: float(f'{e:.3g}') for n, e in errs.items()} })")
            if shape != FLASH_SHAPES[0]:
                continue
            for name, err in errs.items():
                key = "max_abs_err" if dt_name == "bfloat16" \
                    else "max_abs_err_f32"
                entries[name][key] = err
            if dt_name == "bfloat16":
                timed = time_flash(torch, q, k, v, *bwd_in, dk ** -0.5,
                                   rows=b, iters=20)
                for name, e in timed.items():
                    entries[name].update(e)
            del q, k, v, gout, bwd_in
            torch.cuda.empty_cache()
    for s in FLASH_LONG:
        dk, dv = FLASH_SHAPES[0][2:]
        q, k, v, gout = qkv(BATCH, s, dk, dv, torch.bfloat16)
        errs, bwd_in = flash_round(torch, q, k, v, gout, dk ** -0.5,
                                   rows=FLASH_ROWS)
        timed = time_flash(torch, q, k, v, *bwd_in, dk ** -0.5,
                           rows=FLASH_ROWS, iters=5 if s <= 4096 else 2)
        for name, e in timed.items():
            e["max_abs_err"] = errs[name]
            entries[name]["long"].append(e)
            log(f"{name} at S={s}, batch {BATCH}: {e['ms']:.4f} ms "
                f"({FLASH_DESIGN[name]} design) vs "
                f"bound {e['bound_ms']:.4f} ms ({e['bound_kind']}); plain "
                f"over {FLASH_ROWS} rows {e['plain_ms']:.4f} ms; library "
                f"{e['library_ms']} ms; max |err| over {FLASH_ROWS} rows "
                f"{errs[name]:.3g}")
        del q, k, v, gout, bwd_in
        torch.cuda.empty_cache()
    for e in entries.values():
        log(f"{e['name']} at sagan64's shape {e['shape']}: {e['ms']:.4f} ms "
            f"({e['design']} design, {e['registers']} registers, "
            f"{e['spill_bytes']} B spilled) vs bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_kind']}); plain "
            f"{e['plain_ms']:.4f} ms; {e['library']} {e['library_ms']} ms")
    return list(entries.values())


def sagan_broken_backwards():
    """(name, patch) pairs breaking the flash backward on purpose: dq
    zeroed, and the delta term dropped from dkv (ds = p * dp)."""
    from dcgan_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def swap(bwd):
        orig = fa._FlashAttention.backward
        fa._FlashAttention.backward = staticmethod(bwd)
        try:
            yield
        finally:
            fa._FlashAttention.backward = staticmethod(orig)

    orig = fa._FlashAttention.backward

    def dq_zeroed(ctx, g):
        dq, dk, dv, none = orig(ctx, g)
        return dq * 0, dk, dv, none

    def delta_dropped(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do, delta = fa.bwd_stats(q, out, g)
        dq = fa.flash_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta * 0,
                              ctx.scale)
        return dq, dk, dv, None

    return [("flash dq zeroed", swap(dq_zeroed)),
            ("flash dkv without the delta term", swap(delta_dropped))]


def sagan_train_and_check(torch, np, workdir, kernels):
    """Phases 8 and 9. Returns (report, trained state, TrainConfig)."""
    import dataclasses as dc

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.data.synthetic import synthetic_batches
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.steps import init_train_state, \
        make_train_step

    tdir = os.path.join(workdir, "sagan64_train")
    argv = ["--preset", "sagan64", "--synthetic", "--max_steps",
            str(TRAIN_STEPS), "--batch_size", str(BATCH), "--device", "cuda",
            "--checkpoint_dir", tdir, "--seed", str(SEED)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"sagan64 train path launches over {TRAIN_STEPS} steps: {launches}")
    for name, per_step in SAGAN_PER_STEP.items():
        if launches[name] != per_step * TRAIN_STEPS:
            fail(f"kernel {name}: {launches[name]} launches on the sagan64 "
                 f"train path, expected {per_step} per step x {TRAIN_STEPS}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["sagan64 train"] = \
            launches[entry["name"]]
    last = read_events(np, tdir, train_s)

    # every parameter, BN statistic and SN vector moved (but a one-element
    # unit vector, the head's u, which stays +-1)
    init = init_train_state(cfg, device="cuda")
    for group in ("params", "bn"):
        for net in ("gen", "disc"):
            after = convert.flatten(state[group][net])
            for path, a in convert.flatten(init[group][net]).items():
                if a.numel() == 1 and path.startswith("sn_"):
                    continue
                if torch.equal(a, after[path]):
                    fail(f"sagan64 {group}/{net}/{path} did not move in "
                         f"{TRAIN_STEPS} steps")
    log("sagan64: every parameter, BN statistic and SN vector moved")

    # flash route vs dense route from the seeded state with gamma = 0.5
    for net in ("gen", "disc"):
        init["params"][net]["attn"]["gamma"] = torch.full(
            (), 0.5, device="cuda")
    images = torch.from_numpy(next(synthetic_batches(
        BATCH, cfg.model.output_size, cfg.model.c_dim,
        seed=SEED + 3))).cuda()
    z = torch.rand((BATCH, cfg.model.z_dim), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(
                       SEED + 4)) * 2.0 - 1.0
    report = {"steps": TRAIN_STEPS, "batch": BATCH, "train_s": train_s,
              "last_losses": {k: last[k] for k in ("d_loss", "g_loss")},
              "launches": launches}
    steps_by_route = {}
    for dt_name in ("bfloat16", "float32"):
        losses, grads, fns = {}, {}, {}
        for route, use_pallas in (("flash", True), ("dense", False)):
            rcfg = dc.replace(cfg, model=dc.replace(
                cfg.model, compute_dtype=dt_name, use_pallas=use_pallas))
            fns[route] = make_train_step(rcfg)
            grads[route], metrics = fns[route].grads(init, images, z)
            losses[route] = {k: float(v) for k, v in metrics.items()}
            if dt_name == "bfloat16":
                steps_by_route[route] = fns[route].train_step
        rtol, atol = ATTN_ROUTE_TOL[dt_name]
        gaps = {k: abs(losses["flash"][k] - losses["dense"][k])
                / (rtol * abs(losses["dense"][k]) + atol)
                for k in losses["flash"]}
        if not all(np.isfinite(list(losses["flash"].values()))) \
                or max(gaps.values()) > 1.0:
            fail(f"sagan64 losses, flash vs dense ({dt_name}): {losses}, "
                 f"outside rtol={rtol} atol={atol}")
        report[f"route_loss_gap_{dt_name}"] = max(gaps.values())
        rtol, atol = ATTN_GRAD_TOL[dt_name]
        gaps = grad_gaps(convert, grads["flash"], grads["dense"], rtol, atol)
        worst = max(gaps, key=gaps.get)
        report[f"grad_gap_{dt_name}"] = {"leaf": worst, "gap": gaps[worst]}
        report[f"attn_grad_gaps_{dt_name}"] = {
            k: v for k, v in gaps.items() if "/attn/" in k}
        if gaps[worst] > 1.0:
            fail(f"sagan64 gradients, flash vs dense ({dt_name}), outside "
                 f"rtol={rtol} atol={atol}: "
                 f"{ {k: v for k, v in gaps.items() if v > 1.0} }")
        log(f"sagan64 flash route matches the dense route in {dt_name}: "
            f"losses within {report[f'route_loss_gap_{dt_name}']:.3g} of "
            f"their limit, {len(gaps)} gradient leaves, the closest "
            f"{worst} at {gaps[worst]:.3g} of its limit")
        for name, patch in sagan_broken_backwards():
            with patch:
                broken, _ = fns["flash"].grads(init, images, z)
            gaps = grad_gaps(convert, broken, grads["dense"], rtol, atol)
            worst = max(gaps, key=gaps.get)
            report.setdefault("broken_backward_gap", {})[
                f"{name} ({dt_name})"] = {"leaf": worst, "gap": gaps[worst]}
            if not gaps[worst] > 1.0:
                fail(f"sagan64 gradients ({dt_name}): a broken backward "
                     f"({name}) stays within the limits (largest gap "
                     f"{gaps[worst]:.3g}, at {worst})")
            log(f"broken backward caught in {dt_name}: {name}, {worst} at "
                f"{gaps[worst]:.3g} of its limit")

    for route, step in steps_by_route.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(init, images, z)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        report[f"{route}_step_syncs"] = sum(
            "called a synchronizing" in str(w.message) for w in caught)
        _, report[f"{route}_step_call_ms"] = time_ms(
            torch, lambda: step(init, images, z), 5, warmup=1,
            label=f"sagan64 {route} step")
        split = profile_split(torch, lambda: step(init, images, z))
        report[f"{route}_profile"] = split if split is not None \
            else "not measured (no device time in the trace)"
        if split is not None:
            attn = split["ms_per_step"]["flash attention kernels"]
            split["attention_share"] = attn / split["busy_ms"]
            by_kernel = "; ".join(
                f"{k} {v['ms']:.4f} ms in {v['calls']:.0f}"
                for k, v in sorted(split["flash_by_kernel"].items()))
            log(f"sagan64 {route} route step: busy {split['busy_ms']:.3f} "
                f"ms, flash kernels {attn:.3f} ms ({by_kernel}) "
                f"({split['attention_share']:.3f} of busy), idle share "
                f"{split['idle_share']:.3f}, "
                f"{split['launches_per_step']:.0f} launches, "
                f"{report[f'{route}_step_syncs']} synchronization(s); "
                f"host-inclusive {report[f'{route}_step_call_ms']:.3f} ms")
    return report, state, cfg


def sagan_serve_and_check(torch, np, cfg, state, workdir, kernels):
    """Phase 10: the trained EMA G, gamma set to 0.5 so that the attention
    shapes the images, served through the entry point; returns the serve
    row and the sampler timing on both routes."""
    from dcgan_tpu_torch.convert import save_weights
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve import __main__ as serve_main
    from dcgan_tpu_torch.train.steps import tree_map

    mcfg = cfg.model
    params = tree_map(torch.clone, state["ema_gen"])
    params["attn"]["gamma"] = torch.full((), 0.5, device="cuda")
    path = save_weights(os.path.join(workdir, "sagan64_serve", "G.npz"),
                        mcfg, params, state["bn"]["gen"])
    wrappers = all_wrappers()
    reset_counts(wrappers)
    with served_batches(np) as batches:
        row, responses = serve_main.run([
            "--weights", path, "--device", "cuda", "--max_batch",
            str(BATCH), "--demo_requests", str(N_REQUESTS), "--demo_rps",
            "500", "--demo_max_images", "8", "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["sagan64 serve"] = \
            launches[entry["name"]]
    check_captured_serving(torch, np, "sagan64 serve", row, batches)
    log(f"sagan64 served path launches: {launches}")
    if launches["flash_fwd"] < 1 or launches["flash_dq"] \
            or launches["flash_dkv"]:
        fail("the sagan64 served path must launch the flash forward and "
             "no backward")
    params_l, state_l = check_served(torch, np, mcfg, path, row, responses)

    z = torch.from_numpy(np.random.default_rng(SEED + 2).uniform(
        -1.0, 1.0, (BATCH, mcfg.z_dim)).astype(np.float32)).cuda()
    timing = {"batch": BATCH}
    for dt_name in ("bfloat16", "float32"):
        flash = dataclasses.replace(mcfg, compute_dtype=dt_name)
        dense = dataclasses.replace(flash, use_pallas=False)
        a = sampler_apply(params_l, state_l, z, cfg=flash)
        b = sampler_apply(params_l, state_l, z, cfg=dense)
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or err > ROUTE_TOL[dt_name]:
            fail(f"sagan64 flash route vs dense route ({dt_name}): max "
                 f"|err| {err} > {ROUTE_TOL[dt_name]}")
        timing[f"route_err_{dt_name}"] = err
        log(f"sagan64 sampler, flash route matches the dense route in "
            f"{dt_name} (max |err| {err:.3g} <= {ROUTE_TOL[dt_name]}; "
            f"output std {float(b.std()):.3f})")
    # spectral norm adds ~10 launches per layer, so 20 back-to-back calls
    # overflow the launch queue and a spin-held event pair would read the
    # enqueue rate: the device time is the profiled busy time
    dense = dataclasses.replace(mcfg, use_pallas=False)
    for name, route in (("flash_route", mcfg), ("dense_route", dense)):
        def call():
            return sampler_apply(params_l, state_l, z, cfg=route)
        _, timing[f"{name}_call_ms"] = time_ms(
            torch, call, 10, label=f"sagan64 sampler {name}")
        split = profile_split(torch, call)
        timing[f"{name}_busy_ms"] = split["busy_ms"] if split else None
        timing[f"{name}_flash_ms"] = \
            split["ms_per_step"]["flash attention kernels"] if split else None
    log(f"sagan64 sampler at batch {BATCH}, profiled device busy: flash "
        f"route {timing['flash_route_busy_ms']} ms (flash kernel "
        f"{timing['flash_route_flash_ms']} ms), dense route "
        f"{timing['dense_route_busy_ms']} ms; host-inclusive "
        f"{timing['flash_route_call_ms']:.4f} / "
        f"{timing['dense_route_call_ms']:.4f} ms")
    return row, timing


# ---------------------------------------------------------------------------
# celeba64 from TFRecords: checkpoints, resume, sample grids, serving
# ---------------------------------------------------------------------------

# the resume phase's data: celeba64-shaped random images in the preset's
# record dtype, written by the port's write_image_tfrecords
RESUME_RECORDS = 1024
RESUME_SHARDS = 4
# the loader's shuffle pool: a quarter of the records (the preset's 10776
# would hold the whole set ten times over before the first batch)
RESUME_SHUFFLE = 256
# the first run saves after every step and keeps the newest RESUME_KEEP,
# with a sample grid at its last step; the second resumes it to
# RESUME_STEPS
RESUME_FIRST_STEPS = 8
RESUME_STEPS = 12
RESUME_KEEP = 3
RESUME_REQUESTS = 8
# timed saves and restores of the final state, loader batches timed, and
# steps per feed in the TFRecord-vs-synthetic comparison
RESUME_REPEATS = 3
LOADER_BATCHES = 16
FEED_STEPS = 8
# the eager feed steps profiled for the idle share (each profiled eager
# step's thousands of launches take the host about a second to digest)
FEED_PROFILED = 2
# the kernels that only the train step launches (kernel 2 also runs in the
# sampler, kernel 5 only there)
TRAIN_ONLY = ("channel_moments", "scale_shift_act_bwd", "gemm_bias_moments")


def decode_png(np, data: bytes):
    """[H, W, C] uint8 of an 8-bit greyscale or RGB PNG, non-interlaced,
    with no row filter (filter type 0 on every row, as utils/images.py
    writes it), decoded with zlib (no PIL); every chunk's CRC checked."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            fail(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 2) or interlace:
        fail(f"PNG depth {depth}, colour type {color}, interlace "
             f"{interlace}: not decoded here")
    c = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * c + 1):
        fail(f"PNG data holds {raw.size} bytes, not {h} rows of {w * c}")
    rows = raw.reshape(h, w * c + 1)
    if rows[:, 0].any():
        fail("PNG rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


def same_state(torch, convert, name, got, want):
    """Fails unless the two states hold the same leaves, dtypes and bits."""
    fg, fw = convert.flatten(got), convert.flatten(want)
    if sorted(fg) != sorted(fw):
        fail(f"{name}: the trees differ")
    bad = [k for k in fw if fg[k].dtype != fw[k].dtype
           or not torch.equal(fg[k], fw[k])]
    if bad:
        fail(f"{name}: {len(bad)} leaves differ, e.g. {bad[:4]}")
    return len(fw)


def loader_rate(cfg, native=False):
    """(first batch s, images/s after it) of the Python loader (the native
    one with `native`) on the phase's shards, on the host alone."""
    from dcgan_tpu_torch.data.native import NativeLoader
    from dcgan_tpu_torch.data.pipeline import PythonLoader, list_shards

    mcfg = cfg.model
    loader = (NativeLoader if native else PythonLoader)(
        list_shards(cfg.data_dir), batch=cfg.batch_size,
        example_shape=(mcfg.output_size, mcfg.output_size, mcfg.c_dim),
        record_dtype=cfg.record_dtype, min_after_dequeue=cfg.shuffle_buffer,
        n_threads=cfg.num_loader_threads, seed=cfg.seed)
    try:
        t0 = time.perf_counter()
        loader.next()
        t1 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            loader.next()
        t2 = time.perf_counter()
    finally:
        loader.close()
    return t1 - t0, LOADER_BATCHES * cfg.batch_size / (t2 - t1)


def feed_steps(torch, trainer, fns, state, cfg, synthetic):
    """Host-inclusive ms of FEED_STEPS train steps from `state`, each
    pulling its batch from the trainer's feed (the TFRecord loader and
    prefetcher, or the synthetic stream) and reading its loss back, after
    two warm steps; and the profiled idle share of FEED_PROFILED such
    steps."""
    dev = torch.device("cuda", torch.cuda.current_device())
    data = trainer.make_data(cfg, dev, synthetic_data=synthetic)
    z, _ = trainer.step_inputs(cfg, 0, dev)

    def step():
        return fns.train_step(state, next(data), z)[1]["d_loss"].item()

    try:
        for _ in range(2):
            step()
        t0 = time.perf_counter()
        for _ in range(FEED_STEPS):
            step()
        ms = (time.perf_counter() - t0) * 1e3 / FEED_STEPS
        split = profile_split(torch, step, steps=FEED_PROFILED)
    finally:
        data.close()
    return ms, split


def feed_steps_captured(torch, trainer, fns, cfg, synthetic, k):
    """Host-inclusive ms per step of FEED_STEPS steps through the captured
    runner at K = k, each call pulling its batches from the trainer's
    feed and its z from step_inputs and reading its losses back once, after
    the warm-up and both captures; and the profiled idle share of such
    calls."""
    import dataclasses as dc

    from dcgan_tpu_torch.train.warmup import StepRunner, call_size

    dev = torch.device("cuda", torch.cuda.current_device())
    kcfg = dc.replace(cfg, steps_per_call=k)
    runner = StepRunner(fns, fns.init(seed=SEED, device=dev), kcfg, dev)
    data = trainer.make_data(kcfg, dev, synthetic_data=synthetic)
    done = [0]

    def call():
        n = call_size(done[0], done[0] + k, k, runner.warm)
        runner.step([next(data) for _ in range(n)],
                    [trainer.step_inputs(kcfg, done[0] + i, dev)[0]
                     for i in range(n)]).tolist()
        done[0] += n

    try:
        while done[0] < 2 * k:
            call()
        start = done[0]
        t0 = time.perf_counter()
        while done[0] < start + FEED_STEPS:
            call()
        ms = (time.perf_counter() - t0) * 1e3 / (done[0] - start)
        split = profile_split(torch, call, steps=2)
    finally:
        runner.close()
        data.close()
    return ms, split


def resume_and_check(torch, np, workdir, kernels):
    """Phase 11: celeba64 trained from TFRecords through the trainer's
    entry point, checkpointed, restored, resumed, corrupted and served
    from its checkpoint directory; returns the `resume` report."""
    import dataclasses as dc

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.data.synthetic import write_image_tfrecords
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.presets import celeba64 as celeba64_preset
    from dcgan_tpu_torch.serve import __main__ as serve_main
    from dcgan_tpu_torch.train import trainer
    from dcgan_tpu_torch.train.steps import init_train_state, make_train_step
    from dcgan_tpu_torch.utils.checkpoint import STATE_FILENAME, Checkpointer

    root = os.path.join(workdir, "resume")
    run = os.path.join(root, "run")
    base = celeba64_preset()
    cfg = dc.replace(
        base, model=dc.replace(base.model, use_pallas=True,
                               pallas_fused=True),
        batch_size=BATCH, seed=SEED, data_dir=os.path.join(root, "data"),
        checkpoint_dir=run, sample_dir=os.path.join(root, "samples"),
        sample_every_steps=RESUME_FIRST_STEPS, save_model_secs=0.0,
        max_checkpoints=RESUME_KEEP, shuffle_buffer=RESUME_SHUFFLE)
    mcfg = cfg.model
    report = {"records": RESUME_RECORDS, "shards": RESUME_SHARDS,
              "record_dtype": cfg.record_dtype, "batch": BATCH}

    # 1. the data
    t0 = time.perf_counter()
    write_image_tfrecords(cfg.data_dir, num_examples=RESUME_RECORDS,
                          image_size=mcfg.output_size, channels=mcfg.c_dim,
                          num_shards=RESUME_SHARDS,
                          record_dtype=cfg.record_dtype, seed=SEED)
    report["write_s"] = time.perf_counter() - t0
    report["loader_first_batch_s"], report["loader_images_per_s"] = \
        loader_rate(cfg)
    log(f"resume: wrote {RESUME_RECORDS} {cfg.record_dtype} records in "
        f"{RESUME_SHARDS} shards in {report['write_s']:.2f} s; the Python "
        f"loader ({cfg.num_loader_threads} readers, pool "
        f"{cfg.shuffle_buffer}): first batch in "
        f"{report['loader_first_batch_s']:.2f} s, then "
        f"{report['loader_images_per_s']:.0f} images/s")

    # 2. the first run, through the trainer's entry point
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state8 = trainer.train(cfg, max_steps=RESUME_FIRST_STEPS, device="cuda")
    torch.cuda.synchronize()
    report["first_run_s"] = time.perf_counter() - t0
    kept = sorted(int(n) for n in os.listdir(run) if n.isdigit())
    if len(kept) < 2 or kept[-1] != RESUME_FIRST_STEPS:
        fail(f"the first run left checkpoints {kept}")
    grid_path = os.path.join(cfg.sample_dir,
                             f"train_{RESUME_FIRST_STEPS:08d}.png")
    if not os.path.exists(grid_path):
        fail(f"no sample grid {grid_path}")
    log(f"resume: first run of {RESUME_FIRST_STEPS} steps from TFRecords "
        f"in {report['first_run_s']:.1f} s, checkpoints {kept}")

    # 3. the newest checkpoint is the final in-memory state, bit for bit
    ck = Checkpointer(run)
    template = init_train_state(cfg, device="cuda")
    restored = ck.restore_latest(template)
    n_leaves = same_state(torch, convert, "restore of the first run",
                          restored, state8)
    log(f"resume: restore_latest gives step {int(restored['step'])} equal "
        f"to the in-memory state in all {n_leaves} leaves, bit for bit")
    del restored

    # 4. the second run resumes at step 8 and ends at 12
    t0 = time.perf_counter()
    state12 = trainer.train(cfg, max_steps=RESUME_STEPS, device="cuda")
    torch.cuda.synchronize()
    report["second_run_s"] = time.perf_counter() - t0
    if int(state12["step"]) != RESUME_STEPS:
        fail(f"the second run ended at step {int(state12['step'])}")
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    scalars = [e["step"] for e in events if e["kind"] == "scalars"]
    images = [e["step"] for e in events if e["kind"] == "image"]
    if scalars != list(range(1, RESUME_STEPS + 1)) or \
            images != [RESUME_FIRST_STEPS]:
        fail(f"events.jsonl: scalars at {scalars}, images at {images}")
    restored12 = ck.restore_latest(template)
    same_state(torch, convert, "restore of the second run", restored12,
               state12)
    log(f"resume: the second run restored step {RESUME_FIRST_STEPS} and "
        f"ran to {RESUME_STEPS} in {report['second_run_s']:.1f} s; "
        f"events.jsonl continues at step {RESUME_FIRST_STEPS + 1}")

    # 6. a truncated newest step is marked .corrupt; the one before serves
    newest = os.path.join(run, str(RESUME_STEPS), STATE_FILENAME)
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    fallback = ck.restore_latest(template)
    if int(fallback["step"]) != RESUME_STEPS - 1 or not os.path.isdir(
            os.path.join(run, f"{RESUME_STEPS}.corrupt")):
        fail(f"a truncated step {RESUME_STEPS}: restore gave step "
             f"{int(fallback['step'])}, directory {sorted(os.listdir(run))}")
    log(f"resume: truncated step {RESUME_STEPS} became "
        f"{RESUME_STEPS}.corrupt; restore_latest fell back to step "
        f"{RESUME_STEPS - 1}")

    # 7. the checkpoint directory served through the serve entry point
    with served_batches(np) as batches:
        row, responses = serve_main.run([
            "--checkpoint_dir", run, "--device", "cuda", "--max_batch",
            str(BATCH), "--demo_requests", str(RESUME_REQUESTS),
            "--demo_rps", "500", "--demo_max_images", "8", "--seed",
            str(SEED)])
    torch.cuda.synchronize()
    check_captured_serving(torch, np, "resume serve", row, batches)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"resume path launches (two runs, {RESUME_STEPS} steps, a grid, "
        f"{RESUME_REQUESTS} requests): {launches}")
    for name in TRAIN_ONLY:
        if launches[name] != PER_STEP[name] * RESUME_STEPS:
            fail(f"kernel {name}: {launches[name]} launches on the resume "
                 f"path, expected {PER_STEP[name]} per step x "
                 f"{RESUME_STEPS}")
    if launches["scale_shift_act"] <= PER_STEP["scale_shift_act"] * \
            RESUME_STEPS or launches["gemm_bias_scale_act"] < 1:
        fail("the resume path's sampler calls (the grid, the requests) "
             "launched no scale_shift_act or gemm_bias_scale_act")
    if any(launches[name] for name in FLASH_REPLACES):
        fail("the celeba64 resume path launched a flash kernel")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["resume"] = \
            launches[entry["name"]]
    if row["completed"] != RESUME_REQUESTS or row["serve/dropped"] != 0 \
            or row["meta"]["step"] != RESUME_STEPS - 1:
        fail(f"served {row['completed']}/{RESUME_REQUESTS} requests, "
             f"{row['serve/dropped']} dropped, from step "
             f"{row['meta']['step']}")
    worst = 0.0
    for serial, r in enumerate(responses):
        img = r.result(timeout=0)
        z = np.random.default_rng((SEED, serial)).uniform(
            -1.0, 1.0, (img.shape[0], mcfg.z_dim)).astype(np.float32)
        direct = sampler_apply(fallback["params"]["gen"],
                               fallback["bn"]["gen"],
                               torch.from_numpy(z).cuda(), cfg=mcfg)
        worst = max(worst, float(np.abs(direct.float().cpu().numpy()
                                        - img).max()))
    if worst > SERVED_TOL:
        fail(f"images served from the checkpoint differ from the sampler "
             f"on its restored weights by {worst}")
    report["served_max_abs_err"] = worst
    log(f"resume: {RESUME_REQUESTS} requests served from step "
        f"{RESUME_STEPS - 1} of the checkpoint directory equal the "
        f"sampler's on the restored weights (max |err| {worst:.3g} <= "
        f"{SERVED_TOL})")

    # 5. one step from the checkpoint and one from the in-memory state, on
    # the same batch and z
    fns = make_train_step(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    data = trainer.make_data(cfg, dev)
    try:
        batch = next(data)
    finally:
        data.close()
    z, _ = trainer.step_inputs(cfg, RESUME_STEPS, dev)
    a, am = fns.train_step(state12, batch, z)
    b, bm = fns.train_step(restored12, batch, z)
    fa, fb = convert.flatten(a), convert.flatten(b)
    bitwise = all(torch.equal(am[k], bm[k]) for k in am) and all(
        torch.equal(fa[k], fb[k]) for k in fa)
    losses_a = {k: float(v) for k, v in am.items()}
    losses_b = {k: float(v) for k, v in bm.items()}
    rtol, atol = TRAIN_ROUTE_TOL["bfloat16"]
    if not bitwise and any(abs(losses_a[k] - losses_b[k])
                           > rtol * abs(losses_a[k]) + atol
                           for k in losses_a):
        fail(f"one step from the checkpoint vs from memory: losses "
             f"{losses_b} vs {losses_a}, outside rtol={rtol} atol={atol}")
    report["one_step_bitwise"] = bitwise
    log(f"resume: one step from the restored state and one from the "
        f"in-memory state on the same batch and z agree "
        f"{'bit for bit' if bitwise else f'within rtol={rtol} atol={atol}'}"
        f" (losses {losses_a})")
    del a, b, fa, fb

    # 8. the grid decodes, without PIL, to the sampler's images of step 8
    with open(grid_path, "rb") as f:
        grid = decode_png(np, f.read())
    rows, cols = cfg.sample_grid
    size = mcfg.output_size
    if grid.shape != (rows * size, cols * size, mcfg.c_dim):
        fail(f"the sample grid decodes to {grid.shape}")
    sample_z = torch.rand(
        (max(cfg.sample_size, rows * cols), mcfg.z_dim), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(cfg.seed + 1)
    ) * 2.0 - 1.0
    imgs = fns.sample(state8, sample_z).float().cpu().numpy()[:rows * cols]
    want = np.clip((imgs + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)
    want = want.reshape(rows, cols, size, size, -1).transpose(
        0, 2, 1, 3, 4).reshape(grid.shape)
    grid_err = int(np.abs(grid.astype(np.int32) - want).max())
    if grid_err > 1:
        fail(f"the sample grid differs from the sampler's images of step "
             f"{RESUME_FIRST_STEPS} by {grid_err} levels")
    log(f"resume: the grid PNG decodes with zlib to {list(grid.shape)}, "
        f"within {grid_err} level(s) of the sampler's images of step "
        f"{RESUME_FIRST_STEPS}")
    del state8

    # timings: saves and restores of the final state, and the step on each
    # feed, in turns
    ckt = Checkpointer(os.path.join(root, "timing"),
                       max_to_keep=RESUME_REPEATS)
    saves, restores = [], []
    for i in range(RESUME_REPEATS):
        ckt.save(i + 1, state12)
        ckt.wait()
        saves.append(dict(ckt.last_save_stats))
    for _ in range(RESUME_REPEATS):
        ckt.restore_latest(template)
        restores.append(dict(ckt.last_restore_stats))

    def median(rows_, key):
        return sorted(r[key] for r in rows_)[len(rows_) // 2]

    report["checkpoint_bytes"] = int(saves[0]["bytes"])
    report["save_ms"] = median(saves, "save_ms")
    report["save_host_copy_ms"] = median(saves, "host_copy_ms")
    report["save_write_ms"] = median(saves, "write_ms")
    report["restore_ms"] = median(restores, "restore_ms")
    report["restore_verify_ms"] = median(restores, "verify_ms")
    report["restore_read_ms"] = median(restores, "read_ms")
    report["save_ms_runs"] = [r["save_ms"] for r in saves]
    report["restore_ms_runs"] = [r["restore_ms"] for r in restores]
    log(f"resume: checkpoint {report['checkpoint_bytes']} bytes; save "
        f"{report['save_ms']:.1f} ms (host copy "
        f"{report['save_host_copy_ms']:.1f}, write "
        f"{report['save_write_ms']:.1f}), restore "
        f"{report['restore_ms']:.1f} ms (verify "
        f"{report['restore_verify_ms']:.1f}, read "
        f"{report['restore_read_ms']:.1f}), medians of {RESUME_REPEATS}")
    feeds = {"tfrecord": [], "synthetic": []}
    for name in ("tfrecord", "synthetic", "synthetic", "tfrecord"):
        feeds[name].append(feed_steps(torch, trainer, fns, state12, cfg,
                                      name == "synthetic"))
    for name, runs in feeds.items():
        report[f"{name}_step_ms"] = [ms for ms, _ in runs]
        report[f"{name}_idle_share"] = [
            split["idle_share"] if split else "not measured"
            for _, split in runs]
        report[f"{name}_busy_ms"] = [
            split["busy_ms"] if split else "not measured"
            for _, split in runs]
    log(f"resume: one celeba64 step at batch {BATCH} with its feed, "
        f"host-inclusive ms: TFRecord {report['tfrecord_step_ms']}, "
        f"synthetic {report['synthetic_step_ms']}; profiled idle share: "
        f"TFRecord {report['tfrecord_idle_share']}, synthetic "
        f"{report['synthetic_idle_share']}")
    # the same feeds driving the captured runner, K = CAPTURE_K, in turns
    captured = {"tfrecord": [], "synthetic": []}
    for name in ("tfrecord", "synthetic", "synthetic", "tfrecord"):
        captured[name].append(feed_steps_captured(
            torch, trainer, fns, cfg, name == "synthetic", CAPTURE_K))
    for name, runs in captured.items():
        report[f"{name}_captured_step_ms"] = [ms for ms, _ in runs]
        report[f"{name}_captured_idle_share"] = [
            split["idle_share"] if split else "not measured"
            for _, split in runs]
    log(f"resume: the same feeds through the captured runner at "
        f"K={CAPTURE_K}, host-inclusive ms per step: TFRecord "
        f"{report['tfrecord_captured_step_ms']}, synthetic "
        f"{report['synthetic_captured_step_ms']}; profiled idle share: "
        f"TFRecord {report['tfrecord_captured_idle_share']}, synthetic "
        f"{report['synthetic_captured_idle_share']}")
    report["launches"] = launches
    return report


# ---------------------------------------------------------------------------
# captured programs: the train step and the serve and generate rungs as
# CUDA graphs
# ---------------------------------------------------------------------------

# (name, preset, model overrides) of the capture phase; the timed turns
# run the three bf16 ones
CAPTURE_CONFIGS = (
    ("celeba64 bf16 kernel route", "celeba64",
     dict(use_pallas=True, pallas_fused=True)),
    ("celeba64 bf16 cuDNN route", "celeba64", {}),
    ("celeba64 f32 kernel route", "celeba64",
     dict(use_pallas=True, pallas_fused=True, compute_dtype="float32")),
    ("sagan64 bf16 flash route", "sagan64", {}),
)
CAPTURE_STEPS = 8
CAPTURE_K = 4
# steps per timed turn (a multiple of CAPTURE_K), and calls profiled
TIMED_STEPS = 16
PROFILED_CALLS = 2
# the spin that holds the card inside a replay's trace before the replays
# (profile_split's settle), and the traces taken of a replay until one
# holds every port kernel at its per-step count
SETTLE_MS = 5
PROFILE_ATTEMPTS = 3
# a replay's per-step launches of each port kernel, read from the
# profiler's kernel names (a part of each entry's name -> its wrapper)
PROFILE_ENTRIES = {"moments_cluster_kernel": "channel_moments",
                   "ssa_fwd_vec_kernel": "scale_shift_act",
                   "ssa_bwd_vec_kernel": "scale_shift_act_bwd",
                   "gbm_wgmma_kernel": "gemm_bias_moments",
                   "flash_fwd_kernel": "flash_fwd",
                   "flash_dq_kernel": "flash_dq",
                   "flash_dkv_kernel": "flash_dkv"}
# saves under capture: steps, one save after each
SAVE_STEPS = 6
# the trainer's CLI with --steps_per_call CAPTURE_K --aot_warmup: steps
# (the warm-up, single steps to the first boundary, calls of K, a tail)
CLI_STEPS = 13
# generate on phase 11's checkpoint directory: images, batch (the tail of
# 100 - 2 x 48 = 4 rows snaps to the ladder's rung of 4), grid
GEN_IMAGES = 100
GEN_BATCH = 48
GEN_GRID = (8, 8)
GEN_SEED = 7


def per_leaf_adam_step(self, params, grads, state):
    """The Adam step as it was before the multi-tensor one (one set of
    elementwise ops per leaf, in optax's order): the plain version the
    multi-tensor Adam is held against on the card, and the launch count
    before it."""
    import torch

    from dcgan_tpu_torch.train.steps import tree_leaves, tree_map

    if self.grad_clip > 0:
        g_norm = torch.sqrt(sum(torch.sum(g * g)
                                for g in tree_leaves(grads)))
        keep = g_norm < self.grad_clip
        grads = tree_map(lambda g: torch.where(
            keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip), grads)
    b1, b2 = self.b1, self.b2
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                  state["nu"])
    count = state["count"]
    count_inc = count + 1
    t = count_inc.to(torch.float32)
    bc1 = 1 - torch.full((), b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1 - torch.full((), b2, dtype=torch.float32, device=t.device) ** t
    step_size = -self.lr(count)
    eps = self.eps

    def update(p, m, v):
        u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
        return (p + step_size.to(u.dtype) * u).to(p.dtype)

    return tree_map(update, params, mu, nu), {"mu": mu, "nu": nu,
                                              "count": count_inc}


@contextlib.contextmanager
def per_leaf_adam():
    """Train steps inside take the per-leaf Adam."""
    from dcgan_tpu_torch.train import steps

    saved = steps.Adam.step
    steps.Adam.step = per_leaf_adam_step
    try:
        yield
    finally:
        steps.Adam.step = saved


@contextlib.contextmanager
def served_batches(np):
    """Records (source, rung, z, images) of every sampler dispatch of the
    serving plane's sources inside the block."""
    from dcgan_tpu_torch.serve import sources

    batches = []
    original = sources._GeneratorSource.sample

    def sample(self, bucket, z, labels=None):
        out = original(self, bucket, z, labels)
        batches.append((self, bucket, np.array(z, np.float32), out.copy()))
        return out

    sources._GeneratorSource.sample = sample
    try:
        yield batches
    finally:
        sources._GeneratorSource.sample = original


def check_captured_serving(torch, np, name, row, batches):
    """Every served batch equals the eager sampler on its source's weights
    and the same z, bit for bit; no capture after the cold start."""
    from dcgan_tpu_torch.models.dcgan import sampler_apply

    if not batches:
        fail(f"{name}: no served batch recorded")
    for i, (src, bucket, z, images) in enumerate(batches):
        want = sampler_apply(src._params, src._state,
                             torch.from_numpy(z).cuda(), cfg=src.cfg)
        if not np.array_equal(want.float().cpu().numpy(), images):
            fail(f"{name}: served batch {i} (rung {bucket}) differs from "
                 "the eager sampler on the same z")
    if row.get("serve/recompiles_after_warmup") != 0:
        fail(f"{name}: serve/recompiles_after_warmup "
             f"{row.get('serve/recompiles_after_warmup')}")
    compile_ms = {k.rsplit("/", 1)[1]: v for k, v in row.items()
                  if k.startswith("serve/compile_ms/")}
    log(f"{name}: {len(batches)} batches on captured rungs equal the eager "
        f"sampler bit for bit; serve/recompiles_after_warmup 0; capture ms "
        f"{compile_ms}")


def capture_cfg(preset, overrides, k=1):
    """The preset at batch BATCH with the model overrides and K."""
    import dataclasses as dc

    from dcgan_tpu_torch.presets import get_preset

    cfg = get_preset(preset)
    return dc.replace(cfg, batch_size=BATCH, seed=SEED, steps_per_call=k,
                      model=dc.replace(cfg.model, **overrides))


def seeded_state(torch, fns, cfg):
    """The seeded init on the card; attention gates at 0.5 (at 0 the
    block passes x through and its backward carries nothing)."""
    state = fns.init(seed=SEED, device="cuda")
    if cfg.model.attn_res:
        for net in ("gen", "disc"):
            state["params"][net]["attn"]["gamma"] = torch.full(
                (), 0.5, device="cuda")
    return state


def step_inputs(torch, cfg, n):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    m = cfg.model
    images = [torch.rand((BATCH, m.output_size, m.output_size, m.c_dim),
                         generator=gen, device="cuda") * 2 - 1
              for _ in range(n)]
    zs = [torch.rand((BATCH, m.z_dim), generator=gen, device="cuda") * 2 - 1
          for _ in range(n)]
    return images, zs


def eager_steps(fns, state, images, zs):
    """(final state, [[d_loss, d_loss_real, d_loss_fake, g_loss] per
    step]) of eager train_steps."""
    from dcgan_tpu_torch.train.warmup import METRIC_KEYS

    losses = []
    for img, z in zip(images, zs):
        state, m = fns.train_step(state, img, z)
        losses.append([float(m[k]) for k in METRIC_KEYS])
    return state, losses


def runner_steps(runner, images, zs, k, start=0):
    """The runner over len(images) steps from state step `start`, in
    the trainer's call sizes; the losses per step."""
    from dcgan_tpu_torch.train.warmup import call_size

    losses, s, total = [], 0, len(images)
    while s < total:
        n = call_size(start + s, start + total, k, runner.warm)
        losses += runner.step(images[s:s + n], zs[s:s + n]).tolist()
        s += n
    return losses


def replay_profile(torch, runner, k):
    """The profiled replays of the row of k steps: busy ms, wall ms and
    launches per step, the idle share, and each port kernel's launches
    per step."""
    prog = runner.programs[runner.row(k)]
    split = profile_split(torch, prog.run, steps=PROFILED_CALLS,
                          settle=True)
    if split is None:
        return None
    per_step = {"busy_ms": split["busy_ms"] / k,
                "wall_ms": split["wall_ms"] / k,
                "launches_per_step": split["launches_per_step"] / k,
                "idle_share": split["idle_share"]}
    found = {}
    for table in (split["port_by_kernel"], split["flash_by_kernel"]):
        for name, f in table.items():
            for part, wrapper in PROFILE_ENTRIES.items():
                if name.startswith(part):
                    found[wrapper] = found.get(wrapper, 0.0) \
                        + f["calls"] / k
    per_step["port_launches_per_step"] = found
    return per_step


def check_capture_config(torch, name, preset, overrides, report):
    """Eager vs the runner at K = 1 and K = CAPTURE_K from the seeded
    state, bit for bit; no capture and no host synchronization after the
    warm-up; the kernels in a replay's profile."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    cfg = capture_cfg(preset, overrides)
    fns = make_train_step(cfg)
    images, zs = step_inputs(torch, cfg, 2 * CAPTURE_STEPS)
    steps_in, zs_in = images[:CAPTURE_STEPS], zs[:CAPTURE_STEPS]
    eager, losses = eager_steps(fns, seeded_state(torch, fns, cfg),
                                steps_in, zs_in)
    again, losses2 = eager_steps(fns, seeded_state(torch, fns, cfg),
                                 steps_in, zs_in)
    if losses != losses2:
        fail(f"capture {name}: two eager runs differ ({losses[-1]} vs "
             f"{losses2[-1]}): the comparison needs a deterministic step")
    same_state(torch, convert, f"capture {name}: eager run twice", again,
               eager)
    del again
    entry = {}
    for k in (1, CAPTURE_K):
        kcfg = capture_cfg(preset, overrides, k)
        runner = StepRunner(fns, seeded_state(torch, fns, kcfg), kcfg,
                            torch.device("cuda"))
        got = runner_steps(runner, steps_in, zs_in, k)
        if got != losses:
            fail(f"capture {name}, K={k}: losses {got} differ from eager "
                 f"{losses}")
        n_leaves = same_state(torch, convert, f"capture {name}, K={k}",
                              runner.state, eager)
        captured = {n: p.capture_ms for n, p in runner.programs.items()}
        # the next steps: no capture, and no host synchronization in a
        # runner call (slot copies and replays; the readback follows)
        for s in range(CAPTURE_STEPS, 2 * CAPTURE_STEPS, k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = runner.step(images[s:s + k], zs[s:s + k])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if not bool(torch.isfinite(out).all()):
                fail(f"capture {name}, K={k}: non-finite losses")
        after = {n: p.capture_ms for n, p in runner.programs.items()}
        if after != captured:
            fail(f"capture {name}, K={k}: captures after the warm-up: "
                 f"{captured} -> {after}")
        rows = {n: {"capture_ms": p.capture_ms,
                    "pool_mib": p.pool_bytes / 2 ** 20}
                for n, p in runner.programs.items()}
        log(f"capture {name}, K={k}: {CAPTURE_STEPS} steps equal the eager "
            f"steps bit for bit ({n_leaves} state leaves, 4 losses per "
            f"step); {CAPTURE_STEPS} more steps with no capture and no "
            f"host synchronization; programs {rows}")
        entry[f"k{k}"] = rows
        if preset == "sagan64" or (overrides.get("use_pallas") and
                                   cfg.model.compute_dtype == "bfloat16"):
            want = SAGAN_PER_STEP if preset == "sagan64" else PER_STEP
            for attempt in range(PROFILE_ATTEMPTS):
                prof = replay_profile(torch, runner, k)
                if prof is None:
                    fail(f"capture {name}, K={k}: the replay's trace holds "
                         "no device time")
                counts = prof["port_launches_per_step"]
                bad = {w: counts.get(w, 0.0) for w in set(
                    PROFILE_ENTRIES.values()) if want[w] and
                    counts.get(w, 0.0) != want[w]}
                if not bad:
                    break
                log(f"capture {name}, K={k}: trace {attempt + 1} of a "
                    f"replay misses port kernels: {bad}")
            if bad:
                fail(f"capture {name}, K={k}: port kernels per step in "
                     f"{PROFILE_ATTEMPTS} traces of a replay {counts}, "
                     f"expected {want}: {bad}")
            log(f"capture {name}, K={k}: a replay's profile shows the port "
                f"kernels at their per-step counts {counts}")
            entry[f"k{k}_replay_profile"] = prof
        runner.close()
        del runner
        torch.cuda.empty_cache()
    report[name] = entry


def timed_turns(torch, name, preset, overrides, report):
    """Host-inclusive step ms, busy ms and idle share of eager, K = 1 and
    K = CAPTURE_K, in turns; the launches per eager step with the
    per-leaf and the multi-tensor Adam, and the two equal bit for bit."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner, aot_capture, \
        build_warmup_plan

    cfg = capture_cfg(preset, overrides)
    fns = make_train_step(cfg)
    images, zs = step_inputs(torch, cfg, CAPTURE_K)
    state = seeded_state(torch, fns, cfg)
    # the multi-tensor Adam against the per-leaf one, one step on the card
    a, am = fns.train_step(state, images[0], zs[0])
    with per_leaf_adam():
        b, bm = fns.train_step(state, images[0], zs[0])
    same_state(torch, convert, f"{name}: multi-tensor vs per-leaf Adam",
               {"s": a, "m": am}, {"s": b, "m": bm})
    del a, b
    launches = {}
    for adam, ctx in (("per-leaf", per_leaf_adam),
                      ("multi-tensor", contextlib.nullcontext)):
        with ctx():
            # a count: one profiled eager step gives it
            split = profile_split(torch, lambda: fns.train_step(
                state, images[0], zs[0]), steps=1)
        launches[adam] = split["launches_per_step"] if split else \
            "not measured"
    log(f"{name}: the multi-tensor Adam equals the per-leaf one bit for bit "
        f"on the card; launches per eager step {launches}")

    runners, capture_ms, pool = {}, {}, {}
    for k in (1, CAPTURE_K):
        kcfg = capture_cfg(preset, overrides, k)
        runner = StepRunner(fns, seeded_state(torch, fns, kcfg), kcfg,
                            torch.device("cuda"))
        runner.step(images[:1], zs[:1])      # the warm-up step
        capture_ms[k] = aot_capture(runner, build_warmup_plan(
            kcfg, sample=False))
        pool[k] = {n: p.pool_bytes for n, p in runner.programs.items()}
        runners[k] = runner

    def turn(k):
        if k == 0:
            holder = {"s": state}

            def call():
                holder["s"], m = fns.train_step(holder["s"], images[0],
                                                zs[0])
                m["d_loss"].item()
            n = 1
        else:
            runner = runners[k]

            def call():
                runner.step(images[:k], zs[:k]).tolist()
            n = k
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS // n):
            call()
        ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
        if k == 0:
            # the eager step is timed, not profiled: its profiles cost the
            # most of this group's time, and its busy ms is the captured
            # step's (the same kernels)
            return {"step_ms": ms, "busy_ms": "not profiled",
                    "idle_share": "not profiled"}
        split = profile_split(torch, call, steps=PROFILED_CALLS)
        if split is None:
            return {"step_ms": ms, "busy_ms": "not measured",
                    "idle_share": "not measured"}
        return {"step_ms": ms, "busy_ms": split["busy_ms"] / n,
                "idle_share": split["idle_share"],
                "launches_per_step": split["launches_per_step"] / n}

    labels = {0: "eager", 1: "K=1", CAPTURE_K: f"K={CAPTURE_K}"}
    turns = {label: [] for label in labels.values()}
    for k in (0, 1, CAPTURE_K, CAPTURE_K, 1, 0):
        turns[labels[k]].append(turn(k))
    log(f"{name}: host-inclusive step ms, busy ms and idle share in turns "
        f"(eager, K=1, K={CAPTURE_K}, K={CAPTURE_K}, K=1, eager): "
        + "; ".join(f"{label} " + ", ".join(
            f"{t['step_ms']:.3f} ms / {t['busy_ms']} busy / idle "
            f"{t['idle_share']}" for t in runs)
            for label, runs in turns.items()))
    report[name] = {"turns": turns, "capture_ms": capture_ms,
                    "pool_bytes": pool, "launches_per_eager_step": launches}
    log(f"{name}: capture ms {capture_ms}; graph pools {pool} bytes")
    for runner in runners.values():
        runner.close()
    del runners
    torch.cuda.empty_cache()


def save_under_capture(torch, np, workdir, report):
    """A save after every replayed step while the replays go on: each
    checkpoint equals a clone of the static state taken right after its
    step, bit for bit."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step, tree_map
    from dcgan_tpu_torch.train.warmup import StepRunner
    from dcgan_tpu_torch.utils.checkpoint import STATE_FILENAME, Checkpointer

    cfg = capture_cfg("celeba64", dict(use_pallas=True, pallas_fused=True))
    fns = make_train_step(cfg)
    images, zs = step_inputs(torch, cfg, SAVE_STEPS)
    runner = StepRunner(fns, seeded_state(torch, fns, cfg), cfg,
                        torch.device("cuda"))
    ck = Checkpointer(os.path.join(workdir, "save_under_capture"),
                      max_to_keep=SAVE_STEPS)
    clones = {}
    t0 = time.perf_counter()
    for s in range(SAVE_STEPS):
        runner.step(images[s:s + 1], zs[s:s + 1])
        clones[s + 1] = tree_map(torch.clone, runner.state)
        ck.save(s + 1, runner.state)
        runner.wait_for(ck.copy_event)
    ck.wait()
    report["save_under_capture_s"] = time.perf_counter() - t0
    for step, clone in clones.items():
        with np.load(os.path.join(ck.directory, str(step),
                                  STATE_FILENAME)) as npz:
            saved = {k: torch.from_numpy(npz[k]).cuda() for k in npz.files}
        same_state(torch, convert, f"save under capture, step {step}",
                   convert.unflatten(saved), clone)
    same_state(torch, convert, "save under capture, restore_latest",
               ck.restore_latest(runner.state), clones[SAVE_STEPS])
    captured = sorted(runner.programs)
    runner.close()
    log(f"save under capture: {SAVE_STEPS} steps ({captured} replayed), a "
        f"save after each; every checkpoint equals its step's static "
        f"state bit for bit ({report['save_under_capture_s']:.1f} s)")


def generate_and_check(torch, np, workdir, kernels, report):
    """`python -m dcgan_tpu_torch.generate`'s entry point on phase 11's
    checkpoint directory: GEN_IMAGES images, a grid and --npz, equal to
    the eager sampler on the restored weights at the rows rebuilt from
    the documented z draw, the tail on a ladder rung; --interpolate."""
    from dcgan_tpu_torch import generate
    from dcgan_tpu_torch.config import load_config
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve.buckets import build_ladder
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    run = os.path.join(workdir, "resume", "run")
    out = os.path.join(workdir, "generated")
    npz = os.path.join(out, "gen.npz")
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    result = generate.main([
        "--checkpoint_dir", run, "--num_images", str(GEN_IMAGES),
        "--batch_size", str(GEN_BATCH), "--grid",
        f"{GEN_GRID[0]}x{GEN_GRID[1]}", "--npz", npz, "--out_dir", out,
        "--seed", str(GEN_SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["generate"] = \
            launches[entry["name"]]
    if launches["gemm_bias_scale_act"] < 1 or \
            launches["scale_shift_act"] < 1:
        fail(f"generate launched no sampler kernel: {launches}")
    ladder = build_ladder(GEN_BATCH)
    tail = GEN_IMAGES % GEN_BATCH
    want_buckets = [GEN_BATCH] * (GEN_IMAGES // GEN_BATCH) + [
        ladder.snap(tail)]
    if result["buckets"] != want_buckets:
        fail(f"generate dispatched {result['buckets']}, expected "
             f"{want_buckets}")
    cfg = load_config(run)
    mcfg = cfg.model
    state = Checkpointer(run).restore_latest(init_train_state(
        cfg, device="cuda"))
    images = np.load(npz)["images"]
    if images.shape != (GEN_IMAGES, mcfg.output_size, mcfg.output_size,
                        mcfg.c_dim) or images.dtype != np.float32:
        fail(f"generate's npz holds {images.shape} {images.dtype}")
    lo = 0
    for i, n in enumerate(result["buckets"]):
        z = generate.generate_z(GEN_SEED, i, n, mcfg.z_dim)
        want = sampler_apply(state["params"]["gen"], state["bn"]["gen"],
                             torch.from_numpy(z).cuda(), cfg=mcfg)
        take = min(n, GEN_IMAGES - lo)
        if not np.array_equal(want.float().cpu().numpy()[:take],
                              images[lo:lo + take]):
            fail(f"generate batch {i} (rung {n}) differs from the eager "
                 "sampler on its z rows")
        lo += take
    grid = os.path.join(out, f"gen_{int(state['step']):08d}_0000.png")
    with open(grid, "rb") as f:
        pixels = decode_png(np, f.read())
    size = mcfg.output_size
    if pixels.shape != (GEN_GRID[0] * size, GEN_GRID[1] * size,
                        mcfg.c_dim):
        fail(f"generate's grid decodes to {pixels.shape}")
    interp = generate.main([
        "--checkpoint_dir", run, "--interpolate", "--grid",
        f"{GEN_GRID[0]}x{GEN_GRID[1]}", "--out_dir", out, "--seed",
        str(GEN_SEED), "--batch_size", str(GEN_BATCH), "--device", "cuda"])
    with open(interp["paths"][0], "rb") as f:
        ipix = decode_png(np, f.read())
    if ipix.shape != pixels.shape:
        fail(f"the interpolation grid decodes to {ipix.shape}")
    report["generate"] = {"s": gen_s, "buckets": result["buckets"],
                          "compile_ms": result["compile_ms"],
                          "interpolate_buckets": interp["buckets"],
                          "launches": launches, "step": int(state["step"])}
    log(f"generate: {GEN_IMAGES} images from step {int(state['step'])} in "
        f"{gen_s:.1f} s on rungs {result['buckets']} (captures "
        f"{ {k: round(v, 1) for k, v in result['compile_ms'].items()} } "
        f"ms) equal the eager sampler on the rebuilt z rows bit for bit; "
        f"the {GEN_GRID[0]}x{GEN_GRID[1]} grid and the interpolation grid "
        f"decode to {list(pixels.shape)}")


def train_cli_captured(torch, np, workdir, kernels, report):
    """`python -m dcgan_tpu_torch.train`'s entry point with
    --steps_per_call CAPTURE_K --aot_warmup on phase 11's TFRecords:
    every row captured after step 1 (perf/compile_ms/* in events.jsonl),
    one log line per call, kernels 1, 3 and 4 at exactly their per-step
    counts, the final checkpoint equal to the returned state."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.steps import init_train_state
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    run = os.path.join(workdir, "captured_train")
    argv = ["--preset", "celeba64", "--use_pallas", "--pallas_fused",
            "--data_dir", os.path.join(workdir, "resume", "data"),
            "--checkpoint_dir", run, "--steps_per_call", str(CAPTURE_K),
            "--aot_warmup", "--max_steps", str(CLI_STEPS), "--batch_size",
            str(BATCH), "--shuffle_buffer", str(RESUME_SHUFFLE),
            "--sample_every_steps", str(2 * CAPTURE_K), "--sample_dir",
            os.path.join(run, "samples"), "--seed", str(SEED),
            "--device", "cuda"]
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})[
            f"train --steps_per_call {CAPTURE_K}"] = launches[entry["name"]]
    for name in TRAIN_ONLY:
        if launches[name] != PER_STEP[name] * CLI_STEPS:
            fail(f"kernel {name}: {launches[name]} launches in {CLI_STEPS} "
                 f"captured steps, expected {PER_STEP[name]} per step")
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    compile_ms = {k.split("/", 2)[2]: v for e in events
                  for k, v in e.get("values", {}).items()
                  if k.startswith("perf/compile_ms/")}
    want_rows = ["train_step", f"multi_step@k{CAPTURE_K}", "sampler"]
    if sorted(compile_ms) != sorted(want_rows):
        fail(f"--aot_warmup wrote perf/compile_ms for {sorted(compile_ms)}")
    logged = [e["step"] for e in events if e["kind"] == "scalars"
              and "d_loss" in e["values"]]
    want_logged = [1, 2, 3, 4] + list(range(2 * CAPTURE_K, CLI_STEPS,
                                            CAPTURE_K)) + [CLI_STEPS]
    if logged != want_logged:
        fail(f"captured run logged steps {logged}, expected {want_logged}")
    for e in events:
        if "d_loss" in e.get("values", {}) and not np.isfinite(
                e["values"]["d_loss"]):
            fail(f"captured run: step {e['step']} d_loss not finite")
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    restored = Checkpointer(run).restore_latest(init_train_state(
        cfg, device="cuda"))
    same_state(torch, convert, "captured run: its final checkpoint",
               restored, state)
    report["train_cli"] = {"steps": CLI_STEPS, "s": train_s,
                           "compile_ms": compile_ms, "logged": logged,
                           "launches": launches}
    log(f"train --steps_per_call {CAPTURE_K} --aot_warmup: {CLI_STEPS} "
        f"steps from TFRecords in {train_s:.1f} s; perf/compile_ms "
        f"{ {k: round(v, 1) for k, v in compile_ms.items()} }; logged "
        f"steps {logged}; kernels 1, 3, 4 at their per-step counts; the "
        f"final checkpoint equals the returned state")


def capture_and_check(torch, np, workdir, kernels):
    """Phases 12-14; returns the `capture` report."""
    report = {"configs": {}, "timed": {}}
    saved = torch.backends.cudnn.deterministic
    # cuDNN may pick algorithms that sum with atomics, whose order varies
    # from run to run: deterministic ones, so that the bit comparison sees
    # the capture alone
    torch.backends.cudnn.deterministic = True
    try:
        for name, preset, overrides in CAPTURE_CONFIGS:
            check_capture_config(torch, name, preset, overrides,
                                 report["configs"])
    finally:
        torch.backends.cudnn.deterministic = saved
    for name, preset, overrides in CAPTURE_CONFIGS:
        if overrides.get("compute_dtype", "bfloat16") == "bfloat16":
            timed_turns(torch, name, preset, overrides, report["timed"])
    save_under_capture(torch, np, workdir, report)
    train_cli_captured(torch, np, workdir, kernels, report)
    generate_and_check(torch, np, workdir, kernels, report)
    return report


# ---------------------------------------------------------------------------
# Phase 15 (`a1`): the rest of the training step
# ---------------------------------------------------------------------------

# steps of each trainer run of the phase, and of each eager / captured
# comparison; lazy R1's interval and its runs' steps (two intervals)
A1_STEPS = 4
# a1_timed's turns: the captured step only (a profile of an eager step,
# thousands of launches, takes seconds of the host; the eager turns were
# cut to make room for the spatial group)
A1_TURNS = ("K=1",)
A1_COMPARE_STEPS = 3
R1_INTERVAL = 4
R1_STEPS = 8
# the kernel route's new step bodies
A1_CRITIC = ["--n_critic", "2", "--grad_accum", "2", "--diffaug",
             "color,translation,cutout"]
# kernel 5's backward, cotangents against the plain version's autograd on
# the card, max |kernel's - plain's| <= tol * max |plain's|: the same f32
# products in another order (f32); one bf16 ulp where the cotangent of a
# bf16 operand is rounded to bf16
GBSA_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the bound on the noise of a gradient that is 0 in exact arithmetic (a
# bias that feeds a BatchNorm), as a share of the net's largest leaf norm
A1_NOISE = 0.05
# fp8 (e4m3, a 3-bit mantissa) at 128 px. The reference rounds through
# fp8 the operands of a quantized stage and, its casts being
# differentiable, their cotangents too: on the kernel route those of the
# patch matrix, one per copy of each element, on the plain route those of
# the map, summed over the copies. So the two routes agree on the forward
# but not on the cotangent that leaves a quantized stage's input, by the
# reference's design, and every gradient that passes back through one
# (all of G's, D's conv0) differs between them. The step, kernel route
# against cuDNN route: the losses within 3 % (where the routes' bf16
# activations before a quantized stage differ by one bf16 ulp, their fp8
# roundings can differ by one fp8 step, 6 %: tests/test_torch_precision.py's
# fp8 rule); D's other leaves per leaf within TRAIN_GRAD_TOL; the rest
# reported. A quantized stage on its own (a1_fp8_stages): in bf16 the
# output against the cuDNN route, two bf16 ulps in relative L2 (the batch
# statistics come from f32 u on one route, from the bf16 conv output on
# the other); in f32 (TF32 off) the output and every cotangent against the
# same function on the CPU (the kernels' plain versions, the same
# quantization points), 1e-3 in relative L2 (the cotangents pass e4m3 on
# both, so an f32 difference that carries one across a rounding boundary
# moves it by an fp8 step: 1.7e-4 to 4.7e-4 measured, H100 at 700 W; the
# conv bias, whose gradient before a BatchNorm is 0, against BN's shift
# gradient). A stage that skipped a quantization would be off by e4m3's
# rounding noise, ~4 %.
A1_FP8_LOSS_RTOL = 0.03
A1_FP8_STAGE_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-3}


def pre_bn_biases(mcfg):
    """The "<net>/<path>" of every per-channel bias that feeds a
    BatchNorm: G's interior deconvs, D's convs after the first. (G's proj
    bias is one per position and channel, and BN takes out only each
    channel's mean over the positions: its gradient is real.) In the
    resnet generator every conv bias but out_conv's reaches the image
    through BatchNorms only (the 3x3 convs follow one, the skips are 1x1
    or the identity); the stylegan generator and the residual critic have
    no BatchNorm."""
    k = mcfg.num_up_layers
    if mcfg.arch == "resnet":
        from dcgan_tpu_torch.models.resnet import _g_channels

        chans = _g_channels(mcfg)
        return ({f"gen/b{i}_conv{j}/b" for i in range(1, k + 1)
                 for j in (1, 2)}
                | {f"gen/b{i}_skip/b" for i in range(1, k + 1)
                   if chans[i - 1] != chans[i]})
    if mcfg.arch == "stylegan":
        return set()
    return ({f"gen/deconv{i}/b" for i in range(1, k)}
            | {f"disc/conv{i}/b" for i in range(1, k)})


def a1_per_step(n_critic, accum, stages=3):
    """Kernel launches per training step of the kernel route at `n_critic`
    critic updates and `accum` microbatches, each net with `stages` fused
    stages (3 at 64 px, 4 at 128), derived from the step: per critic
    update and microbatch, G's forward (bn0's moments and epilogue and the
    s stages: 1 channel_moments, s + 1 scale_shift_act, s
    gemm_bias_moments), D on the real and the fake batch (2s and 2s) and
    D's backward through both (2s scale_shift_act_bwd); per microbatch of
    G's update, G's forward (1, s + 1, s), D on the fake batch (s and s)
    and the backward through D and G (s + s + bn0's 1). At (1, 1, 3) this
    is PER_STEP."""
    n, k, s = n_critic, accum, stages
    return dict(PER_STEP, channel_moments=k * (n + 1),
                scale_shift_act=k * (n * (3 * s + 1) + 2 * s + 1),
                scale_shift_act_bwd=k * (n * 2 * s + 2 * s + 1),
                gemm_bias_moments=k * (n * 3 * s + 2 * s))


def a1_argv(workdir, name, argv):
    """train.cli.main's arguments for a phase-15 run called `name`."""
    tdir = os.path.join(workdir, name)
    return ["--synthetic", "--max_steps", str(A1_STEPS), "--batch_size",
            str(BATCH), "--device", "cuda", "--checkpoint_dir", tdir,
            "--sample_dir", os.path.join(tdir, "samples"), "--seed",
            str(SEED), "--activation_summary_steps", "0"] + argv


def a1_config(workdir, name, argv):
    from dcgan_tpu_torch.train import cli

    return cli.config_from_args(cli.build_parser().parse_args(
        a1_argv(workdir, name, argv)))


def a1_check_kernels(torch, workdir, name, argv, batch, report):
    """Kernels 1-4 against their plain versions at every shape the step of
    run `name` gives them at `batch` images (a microbatch under
    grad_accum), in bf16 and f32, each launched twice to show the bits
    repeat (kernel 2 once): kernel 1 at G's bn0 and every fused stage,
    kernels 2 and 3 at every BN epilogue with the stage's act, kernel 4 at
    every fused stage on operands built as the step builds them, through
    fake_quant_fp8 where the config quantizes the stage. Each takes the
    design its plan picks, logged; the shapes the kernel route runs take
    TRAIN_DESIGN's. Called before the run's counts are set to 0."""
    from dcgan_tpu_torch.models.dcgan import _stage_quant

    mcfg = a1_config(workdir, name, argv).model
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 23)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    top = mcfg.gf_dim * 2 ** (mcfg.num_up_layers - 1)
    stages = train_shapes(mcfg, batch)
    epilogues = [("G bn0", batch * mcfg.base_size ** 2, top, "relu")] + [
        (st["name"], st["m"], st["c"], st["act"]) for st in stages]
    errs = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        e = errs[dt_name] = dict.fromkeys(TRAIN_DESIGN, 0.0)
        for stage, n, c, act in epilogues:
            tag = f"a1 {name} {stage} {dt_name}"
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            err, plan = check_moments(torch, tag, x)
            if stage == "G bn0" and \
                    plan.design != TRAIN_DESIGN["channel_moments"]:
                fail(f"channel_moments {tag} plans {plan}")
            e["channel_moments"] = max(e["channel_moments"], err)
            gr = rand(n, c).to(dt)
            scale, shift = rand(c, lo=0.5, hi=1.5), rand(c, lo=-0.5, hi=0.5)
            e["scale_shift_act_bwd"] = max(e["scale_shift_act_bwd"],
                                           check_ssa_bwd(
                torch, tag, x, gr, scale, shift, act,
                TRAIN_DESIGN["scale_shift_act_bwd"]))
            e["scale_shift_act"] = max(e["scale_shift_act"], check_ssa_fwd(
                torch, tag, x, scale, shift, (act,)))
            log(f"a1 {name}: {stage} [{n}, {c}] {dt_name}: channel_moments "
                f"plan {plan._asdict()}; scale_shift_act and its backward "
                "on their TRAIN_DESIGN designs; all match their plain "
                "versions and repeat bitwise")
        for st in stages:
            out_res = 2 * st["res"] if st["transpose"] else st["res"]
            quant = _stage_quant(mcfg, out_res) == "fp8"
            tag = f"a1 {name} {st['name']} {dt_name}"
            _, p2d, w2d, b = gbm_operands(torch, mcfg, st, dt, g, batch,
                                          quant=quant)
            err, plan = check_gbm(torch, tag, p2d, w2d, b, dt)
            if dt is torch.bfloat16 and \
                    plan.design != TRAIN_DESIGN["gemm_bias_moments"]:
                fail(f"gemm_bias_moments {tag} plans {plan}")
            e["gemm_bias_moments"] = max(e["gemm_bias_moments"], err)
            on = " on fp8 operands" if quant else ""
            log(f"a1 {name}: gemm_bias_moments {st['name']} M={st['m']} "
                f"K={st['k']} C={st['c']} {dt_name}{on} matches its plain "
                f"version and repeats bitwise; plan {plan._asdict()}")
            del p2d, w2d
            torch.cuda.empty_cache()
    report.setdefault("kernel_checks", {})[f"{name} batch {batch}"] = errs


def a1_cli(torch, np, workdir, name, argv, per_step, kernels, path=None):
    """train.cli.main on cuda for A1_STEPS steps with `argv` added, the
    launch counters set to 0 just before and read just after: each kernel
    exactly per_step[kernel] x A1_STEPS launches, kernels 1-4 on their
    TRAIN_DESIGN designs; finite losses (and penalty) in events.jsonl.
    Adds the launches to launches_by_path[path] when path is given.
    Returns (final state, config, events' values, seconds)."""
    from dcgan_tpu_torch.train import cli

    full = a1_argv(workdir, name, argv)
    cfg = a1_config(workdir, name, argv)
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state = cli.main(full)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for n, want in per_step.items():
        if launches[n] != want * A1_STEPS:
            fail(f"a1 {name}: kernel {n} launched {launches[n]} times, "
                 f"expected {want} per step x {A1_STEPS}")
    for n, design in TRAIN_DESIGN.items():
        by = wrappers[n].launches_by_design
        if launches[n] and by[design] != launches[n]:
            fail(f"a1 {name}: {n} launches must all take design {design}: "
                 f"{by}")
    if path is not None:
        for entry in kernels:
            by_path = entry.setdefault("launches_by_path", {})
            by_path[path] = by_path.get(path, 0) + launches[entry["name"]]
    with open(os.path.join(cfg.checkpoint_dir, "events.jsonl")) as f:
        rows = [json.loads(line)["values"] for line in f
                if json.loads(line)["kind"] == "scalars"]
    rows = [r for r in rows if "d_loss" in r]
    if len(rows) != A1_STEPS or not all(
            np.isfinite([v for k, v in r.items() if not k.startswith(
                "perf/")]).all() for r in rows):
        fail(f"a1 {name}: {len(rows)} loss rows, or non-finite: {rows}")
    log(f"a1 {name}: {A1_STEPS} steps of train.cli.main in {secs:.1f} s, "
        f"launches {launches}, last losses "
        f"{ {k: round(v, 5) for k, v in rows[-1].items() if '/' not in k} }")
    return state, cfg, rows, secs


def a1_inputs(torch, cfg, n):
    """n steps' images (seeded on the card) and the trainer's z and draws
    of steps 0 .. n-1."""
    from dcgan_tpu_torch.train import trainer

    images, _ = step_inputs(torch, cfg, n)
    zs, draws = zip(*(trainer.step_inputs(cfg, s, torch.device("cuda"))
                      for s in range(n)))
    return images, list(zs), list(draws)


def cond_labels(torch, cfg, n):
    """n steps' labels of a conditional config, each batch holding every
    class (a shifted arange), on the card; None for an unconditional
    one."""
    k = cfg.model.num_classes
    if not k:
        return None
    return [((torch.arange(BATCH, device="cuda") + 3 * i) % k).int()
            for i in range(n)]


def a1_capture_compare(torch, name, cfg, n, ks=(1,)):
    """n eager steps against the runner at each K of `ks` from the seeded
    state on the trainer's inputs (and cond_labels' for a conditional
    config), cuDNN deterministic: every metric of every step and every
    state leaf equal bit for bit. Returns the eager metrics per step
    (metric_keys order)."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner, call_size, \
        metric_keys

    keys = metric_keys(cfg)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fns = make_train_step(cfg)
        images, zs, draws = a1_inputs(torch, cfg, n)
        labels = cond_labels(torch, cfg, n)
        state = fns.init(seed=SEED, device="cuda")
        eager = []
        for i in range(n):
            state, m = fns.train_step(state, images[i], zs[i], draws[i],
                                      None if labels is None else labels[i])
            eager.append([float(m[k]) for k in keys])
        for k in ks:
            kcfg = dataclasses.replace(cfg, steps_per_call=k)
            runner = StepRunner(fns, fns.init(seed=SEED, device="cuda"),
                                kcfg, torch.device("cuda"))
            got, s = [], 0
            while s < n:
                c = call_size(s, n, k, runner.warm)
                got += runner.step(
                    images[s:s + c], zs[s:s + c], draws[s:s + c], start=s,
                    labels=None if labels is None
                    else labels[s:s + c]).tolist()
                s += c
            if got != eager:
                fail(f"a1 {name}, K={k}: metrics {got} differ from eager "
                     f"{eager}")
            leaves = same_state(torch, convert, f"a1 {name}, K={k}",
                                runner.state, state)
            log(f"a1 {name}, K={k}: {n} captured steps equal the eager "
                f"steps bit for bit ({leaves} leaves, {len(keys)} metrics "
                f"per step); programs {sorted(runner.programs)}")
            runner.close()
            del runner
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved
    return eager


def net_gaps(convert, got, want, skip):
    """Net -> |got - want| / |want| over the net's leaves as one vector,
    the "<net>/<path>" leaves of `skip` left out."""
    out = {}
    for net in ("gen", "disc"):
        g, w = convert.flatten(got[net]), convert.flatten(want[net])
        keep = [p for p in w if f"{net}/{p}" not in skip]
        diff = sum(float((g[p].float() - w[p].float()).norm()) ** 2
                   for p in keep)
        out[net] = (diff / sum(float(w[p].float().norm()) ** 2
                               for p in keep)) ** 0.5
    return out


def a1_route_grads(torch, name, cfg, report, state=None):
    """The losses and both nets' gradients (`grads`: D's of the first
    critic update, G's against the seeded D, each over its microbatches
    with its draws) at the seeded state (or at `state`: the progressive
    group's merged state after a switch), the kernel route against the
    cuDNN + torch-BN route on the same images, z and draws, within
    TRAIN_ROUTE_TOL and TRAIN_GRAD_TOL (bf16); under the fp8 policy the
    losses within A1_FP8_LOSS_RTOL and only the gradients that pass back
    through no quantized stage's input (D's from conv1 on) per leaf.
    Returns the kernel route's (grads, losses) and each net's gradient gap
    in relative L2."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step

    images, zs, draws = a1_inputs(torch, cfg, 1)
    labels = cond_labels(torch, cfg, 1)
    losses, grads = {}, {}
    for route, flags in (("kernel", {}), ("cudnn", {"use_pallas": False,
                                                    "pallas_fused": False})):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **flags))
        fns = make_train_step(rcfg)
        if state is None:
            state = fns.init(seed=SEED, device="cuda")
        grads[route], metrics = fns.grads(
            state, images[0], zs[0], draws[0],
            None if labels is None else labels[0])
        losses[route] = {k: float(v) for k, v in metrics.items()}
    fp8 = cfg.precision == "fp8"
    dt_name = cfg.model.compute_dtype
    rtol, atol = (A1_FP8_LOSS_RTOL, 0.0) if fp8 \
        else TRAIN_ROUTE_TOL[dt_name]
    bad = [k for k in losses["kernel"]
           if not abs(losses["kernel"][k] - losses["cudnn"][k])
           <= rtol * abs(losses["cudnn"][k]) + atol]
    if bad:
        fail(f"a1 {name}: losses, kernel vs cuDNN route {losses}, outside "
             f"rtol={rtol} atol={atol}: {bad}")
    rtol, atol = TRAIN_GRAD_TOL[dt_name]
    gaps = grad_gaps(convert, grads["kernel"], grads["cudnn"], rtol, atol)
    # the biases that feed a BatchNorm have a gradient of 0 in exact
    # arithmetic: on each route theirs is the rounding noise of a bf16
    # batch sum, which the bf16 params of the precision policies leave as
    # large as the atol term, so they are held to a bound of their own:
    # noise, at most A1_NOISE of the net's largest leaf norm on each route
    noise = {}
    for key in sorted(pre_bn_biases(cfg.model)):
        net, path = key.split("/", 1)
        top = max(float(x.norm()) for x in convert.flatten(
            grads["cudnn"][net]).values())
        noise[key] = max(float(convert.flatten(grads[r][net])[path].norm())
                         for r in grads) / top
        del gaps[key]
    loud = {k: v for k, v in noise.items() if not v <= A1_NOISE}
    if loud:
        fail(f"a1 {name}: BN-feeding biases' gradients above noise "
             f"(share of the net's largest leaf norm): {loud}")
    nets = net_gaps(convert, grads["kernel"], grads["cudnn"],
                    pre_bn_biases(cfg.model))
    held = {k: v for k, v in gaps.items()
            if not fp8 or (k.startswith("disc/") and "/conv0/" not in k)}
    worst = max(held, key=held.get)
    report[f"{name}_route"] = {"losses": losses, "worst_grad_gap":
                               [worst, gaps[worst]],
                               "bn_bias_noise": max(noise.values()),
                               "net_grad_gap": nets}
    if not gaps[worst] <= 1.0:
        fail(f"a1 {name}: gradients, kernel vs cuDNN route, outside "
             f"rtol={rtol} atol={atol}: "
             f"{ {k: v for k, v in held.items() if not v <= 1.0} }")
    if fp8:
        other = max((k for k in gaps if k not in held), key=gaps.get)
        report[f"{name}_route"]["farthest_not_held"] = [other, gaps[other]]
    log(f"a1 {name}: kernel vs cuDNN route losses {losses['kernel']} vs "
        f"{losses['cudnn']}; {len(held)} gradient leaves within limits, "
        f"the closest {worst} at {gaps[worst]:.3g} of its limit; each "
        f"net's gradient off by {nets} (relative L2)"
        + (f"; of the leaves not held, {other} farthest at "
           f"{gaps[other]:.3g} of the limit" if fp8 else ""))
    return grads["kernel"], losses["kernel"], nets


def a1_timed(torch, name, cfg, report):
    """One step's host-inclusive ms, busy ms and idle share in the turns
    of A1_TURNS ("eager": fns.train_step; "K=1": the runner), one each."""
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    fns = make_train_step(cfg)
    images, zs, draws = a1_inputs(torch, cfg, 2)
    holder = {"s": fns.init(seed=SEED, device="cuda")}
    runner = StepRunner(fns, fns.init(seed=SEED, device="cuda"),
                        dataclasses.replace(cfg, steps_per_call=1),
                        torch.device("cuda"))
    runner.step(images[:1], zs[:1], draws[:1], start=0)

    def eager():
        holder["s"], m = fns.train_step(holder["s"], images[1], zs[1],
                                        draws[1], penalty=True)
        m["d_loss"].item()

    def captured():
        # start 0: the penalty row under lazy R1, the only row otherwise
        runner.step(images[1:2], zs[1:2], draws[1:2], start=0).tolist()

    def turn(fn, settle):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS // 4):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / (TIMED_STEPS // 4)
        split = profile_split(torch, fn, steps=PROFILED_CALLS,
                              settle=settle)
        if split is None:
            return {"step_ms": ms, "busy_ms": "not measured",
                    "idle_share": "not measured"}
        return {"step_ms": ms, "busy_ms": split["busy_ms"],
                "idle_share": split["idle_share"],
                "launches_per_step": split["launches_per_step"]}
    turns = {label: [] for label in A1_TURNS}
    for label in A1_TURNS:
        turns[label].append(turn(eager if label == "eager" else captured,
                                 label != "eager"))
    report[name] = turns
    report[f"{name}_pool_bytes"] = {n: p.pool_bytes
                                    for n, p in runner.programs.items()}
    log(f"a1 {name}: one step, host-inclusive ms / busy ms / idle share "
        f"in turns {A1_TURNS}: " + "; ".join(
            f"{label} " + ", ".join(
                f"{t['step_ms']:.3f} / {t['busy_ms']} / {t['idle_share']}"
                for t in runs) for label, runs in turns.items()))
    runner.close()
    del runner
    torch.cuda.empty_cache()


def a1_fp8_stages(torch, report):
    """The two stages the fp8 policy quantizes at 128 px (G's deconv4,
    64 px out; D's conv1, 64 px in) on their own, on a seeded input,
    params and output cotangent, as A1_FP8_STAGE_TOL says: in bf16 at
    batch 64, fused_conv_bn_act(quant="fp8") on the card (kernel 4, BN's
    batch arithmetic, kernel 2) against the cuDNN route's conv with
    quant="fp8" and torch BN, the output; the unquantized stage farther
    from the quantized one than that limit; in f32 at batch 16, the same
    call on the card (kernels 4 and 2, kernel 3 in its backward) against
    itself on the CPU (the kernels' plain versions), the output and the
    cotangents of x, w, b and BN's scale and bias, and the output against
    the cuDNN route's."""
    from dcgan_tpu_torch.ops.fused import fused_conv_bn_act
    from dcgan_tpu_torch.ops.layers import conv2d_apply, deconv2d_apply
    from dcgan_tpu_torch.ops.norm import batch_norm_apply

    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rel(a, b, ref):
        return float((a.float().cpu() - b.float().cpu()).norm()
                     / ref.float().cpu().norm())

    out = {}
    for name, transpose, act, res, cin, cout in (
            ("G deconv4", True, "relu", 32, 128, 64),
            ("D conv1", False, "lrelu", 64, 64, 128)):
        ho = 2 * res if transpose else res // 2
        for dt_name, batch in (("bfloat16", BATCH), ("float32", BATCH // 4)):
            dt = getattr(torch, dt_name)
            h = randn(batch, res, res, cin)
            *leaves0, gy = [t.to(dt) for t in (
                h.relu() if act == "relu" else
                torch.nn.functional.leaky_relu(h, 0.2),
                randn(5, 5, cin, cout, scale=0.02), randn(cout, scale=0.01),
                1.0 + randn(cout, scale=0.02), randn(cout, scale=0.02),
                randn(batch, ho, ho, cout))]

            def run(route, quant, dev="cuda"):
                xs = [t.to(dev).requires_grad_(True) for t in leaves0]
                x, w, b, scale, shift = xs
                conv, bn = {"w": w, "b": b}, {"scale": scale, "bias": shift}
                state = {"mean": torch.zeros(cout, device=dev, dtype=dt),
                         "var": torch.ones(cout, device=dev, dtype=dt)}
                if route == "kernel":
                    y, _ = fused_conv_bn_act(
                        conv, bn, state, x, transpose=transpose, kernel=5,
                        stride=2, train=True, act=act, leak=0.2,
                        compute_dtype=dt, quant=quant)
                else:
                    layer = deconv2d_apply if transpose else conv2d_apply
                    y, _ = batch_norm_apply(
                        bn, state, layer(conv, x, compute_dtype=dt,
                                         quant=quant),
                        train=True, act=act, leak=0.2)
                return y, torch.autograd.grad(y, xs, gy.to(dev))

            y_k, g_k = run("kernel", "fp8")
            errs = {"out_vs_cudnn": rel(y_k, run("cudnn", "fp8")[0], y_k)}
            if dt is torch.bfloat16:
                errs["unquantized"] = rel(run("kernel", "")[0], y_k, y_k)
            else:
                y_p, g_p = run("kernel", "fp8", "cpu")
                errs["out_vs_plain"] = rel(y_k, y_p, y_p)
                for label, a, b in zip(("x", "w", "b", "scale", "shift"),
                                       g_k, g_p):
                    errs[f"d{label}_vs_plain"] = rel(
                        a, b, g_p[4] if label == "b" else b)
            limit = A1_FP8_STAGE_TOL[dt_name]
            bad = {k: v for k, v in errs.items()
                   if k != "unquantized" and not v <= limit}
            if bad:
                fail(f"a1 fp8 stage {name} {dt_name}: off by {bad} "
                     f"(relative L2), limit {limit}")
            if errs.get("unquantized", 1.0) <= limit:
                fail(f"a1 fp8 stage {name}: quant='fp8' moved the output "
                     f"by only {errs['unquantized']:.3g}")
            out[f"{name} {dt_name}"] = errs
            log(f"a1 fp8 stage {name} [{batch}, {res}, {res}, {cin}] -> "
                f"{cout} {dt_name} (relative L2): "
                f"{ {k: f'{v:.3g}' for k, v in errs.items()} }")
            del y_k, g_k
            torch.cuda.empty_cache()
    report["fp8_stages"] = out


def check_gbsa_backward(torch, report):
    """Kernel 5 with inputs that require grad at D's fused stage shapes
    (celeba64, batch 64, lrelu), in bf16 and f32: the output has a
    grad_fn; its five cotangents (the port's backward, torch products)
    against autograd through the plain version on the same card tensors,
    within GBSA_BWD_TOL; the forward launches once, the backward not."""
    from dcgan_tpu_torch.ops.fused import gemm_bias_scale_act, \
        gemm_bias_scale_act_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    shapes = []
    for i, (res, cin) in enumerate(((32, 64), (16, 128), (8, 256)), 1):
        ho = res // 2
        shapes.append((f"conv{i}", BATCH * ho * ho, 25 * cin, 2 * cin))
    out = {}
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        for name, m, k, c in shapes:
            p = (torch.randn((m, k), generator=gen, device="cuda")
                 * 0.5).to(dt)
            w = (torch.randn((k, c), generator=gen, device="cuda")
                 * k ** -0.5).to(dt)
            vecs = [torch.randn((c,), generator=gen, device="cuda") * s + o
                    for s, o in ((0.1, 0.0), (0.2, 1.0), (0.1, 0.0))]
            g = torch.randn((m, c), generator=gen, device="cuda").to(dt)
            ins = [t.detach().clone().requires_grad_(True)
                   for t in [p, w] + vecs]
            before = gemm_bias_scale_act.launches
            y = gemm_bias_scale_act(*ins, "lrelu", 0.2, dt)
            if y.grad_fn is None:
                fail(f"gemm_bias_scale_act {name} {dt_name}: no grad_fn")
            got = torch.autograd.grad(y, ins, g)
            torch.cuda.synchronize()
            if gemm_bias_scale_act.launches != before + 1:
                fail(f"gemm_bias_scale_act {name} {dt_name}: "
                     f"{gemm_bias_scale_act.launches - before} launches "
                     "for one forward and backward, expected 1")
            ref = [t.detach().clone().requires_grad_(True)
                   for t in [p, w] + vecs]
            want = torch.autograd.grad(gemm_bias_scale_act_plain(
                *ref, "lrelu", 0.2, dt), ref, g)
            errs = {}
            for label, a, b in zip(("p2d", "w2d", "b", "scale", "shift"),
                                   got, want):
                if a.dtype != b.dtype:
                    fail(f"gemm_bias_scale_act {name} {dt_name}: d{label} "
                         f"is {a.dtype}, the plain version's {b.dtype}")
                scale = float(b.float().abs().max())
                errs[label] = float((a.float() - b.float()).abs().max()) / \
                    scale
                if not errs[label] <= GBSA_BWD_TOL[dt_name]:
                    fail(f"gemm_bias_scale_act backward {name} {dt_name}: "
                         f"d{label} off by {errs[label]:.3g} of its largest "
                         f"value (limit {GBSA_BWD_TOL[dt_name]})")
            out[f"{name} {dt_name}"] = errs
            log(f"gemm_bias_scale_act backward {name} [{m}, {k}] @ "
                f"[{k}, {c}] {dt_name}: cotangents within "
                f"{GBSA_BWD_TOL[dt_name]} of the plain version's autograd "
                f"({ {kk: f'{v:.2g}' for kk, v in errs.items()} })")
    report["gbsa_backward_rel_err"] = out


def a1_and_check(torch, np, workdir, kernels):
    """Phase 15; returns the `a1` report."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.config import ModelConfig, TrainConfig
    from dcgan_tpu_torch.ops.layers import fake_quant_fp8
    from dcgan_tpu_torch.presets import get_preset
    from dcgan_tpu_torch.train.steps import init_train_state, \
        make_train_step, tree_leaves
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    report = {"timed": {}}
    none = {n: 0 for n in PER_STEP}

    # 1. WGAN-GP at full width on the plain route: the trainer, then
    # captured against eager
    state, cfg, rows, secs = a1_cli(torch, np, workdir, "wgan_gp",
                                    ["--preset", "wgan-gp"], none, kernels)
    gps = [r["gp"] for r in rows]
    if not all(v > 0 for v in gps):
        fail(f"a1 wgan-gp: gp {gps}")
    init = init_train_state(cfg, device="cuda")
    for group in ("params", "bn"):
        after = convert.flatten(state[group]["disc"])
        for path, a in convert.flatten(init[group]["disc"]).items():
            # the critic's output bias has no gradient: it cancels between
            # -E[D(real)] and E[D(fake)], and the penalty's input gradient
            # does not see it
            if path != "head/b" and torch.equal(a, after[path]):
                fail(f"a1 wgan-gp: {group}/disc/{path} did not move")
    report["wgan_gp"] = {"train_s": secs, "gp": gps, "last": rows[-1]}
    log(f"a1 wgan-gp: gp {gps}; every D leaf moved but head/b (no "
        "gradient in a Wasserstein critic)")
    a1_capture_compare(torch, "wgan-gp", capture_cfg("wgan-gp", {}),
                       A1_COMPARE_STEPS)

    # 2. lazy R1 on the cuDNN route: the penalty on steps 0 and 4
    r1_cfg = dataclasses.replace(capture_cfg("celeba64", {}), r1_gamma=10.0,
                                 r1_interval=R1_INTERVAL)
    eager = a1_capture_compare(torch, "r1 lazy", r1_cfg, R1_STEPS,
                               ks=(1, CAPTURE_K))
    r1 = [row[-1] for row in eager]
    if [v > 0 for v in r1] != [s % R1_INTERVAL == 0
                               for s in range(R1_STEPS)] \
            or not all(v == 0.0 for s, v in enumerate(r1)
                       if s % R1_INTERVAL):
        fail(f"a1 r1 lazy: r1 per step {r1}, expected > 0 on every "
             f"{R1_INTERVAL}th step from 0 and 0 elsewhere")
    report["r1_lazy"] = {"r1": r1}
    log(f"a1 r1 lazy: r1 per step {r1}")

    # 3. the kernel route with n_critic 2, 2 microbatches and DiffAugment:
    # kernels 1-4 at the microbatch's shapes first
    kernel = ["--preset", "celeba64", "--use_pallas", "--pallas_fused"]
    a1_check_kernels(torch, workdir, "kernel_critic", kernel + A1_CRITIC,
                     BATCH // 2, report)
    state, cfg, rows, secs = a1_cli(torch, np, workdir, "kernel_critic",
                                    kernel + A1_CRITIC, a1_per_step(2, 2),
                                    kernels, path="a1")
    report["kernel_critic"] = {"train_s": secs, "last": rows[-1],
                               "per_step": a1_per_step(2, 2)}
    kcfg = dataclasses.replace(cfg, max_steps=1_200_000)
    a1_route_grads(torch, "kernel_critic", kcfg, report)
    a1_capture_compare(torch, "kernel_critic", kcfg, A1_COMPARE_STEPS)

    # 4. the precision policies on the kernel route: bf16 at 64 px, fp8 at
    # 128 px (no stage of a 64 px model reaches the 64 px gate; at 128 G's
    # last fused stage and D's conv1 quantize), its kernels at its shapes
    # first
    fp8_argv = ["--precision", "fp8", "--output_size", "128"]
    a1_check_kernels(torch, workdir, "kernel_fp8", kernel + fp8_argv, BATCH,
                     report)
    timed = {}
    for policy, argv, per_step in (
            ("bf16", ["--precision", "bf16"], PER_STEP),
            ("fp8", fp8_argv, a1_per_step(1, 1, stages=4))):
        state, cfg, rows, secs = a1_cli(
            torch, np, workdir, f"kernel_{policy}", kernel + argv, per_step,
            kernels, path="a1")
        for net in ("gen", "disc"):
            if {t.dtype for t in tree_leaves(state["params"][net])} != {
                    torch.bfloat16} or {t.dtype for t in tree_leaves(
                        state["opt"][net]["mu"])} != {torch.float32}:
                fail(f"a1 {policy}: {net}'s params must be bf16 and its "
                     "Adam mu f32")
        restored = Checkpointer(cfg.checkpoint_dir).restore_latest(
            init_train_state(cfg, device="cuda"))
        same_state(torch, convert, f"a1 {policy}: the checkpoint",
                   restored, state)
        pcfg = timed[f"kernel_{policy}_{cfg.model.output_size}px"] = \
            dataclasses.replace(cfg, max_steps=1_200_000)
        grads, losses, route_gap = a1_route_grads(
            torch, f"kernel_{policy}", pcfg, report)
        report[f"kernel_{policy}"] = {"train_s": secs, "last": rows[-1],
                                      "output_size": cfg.model.output_size,
                                      "per_step": per_step}
        log(f"a1 {policy} at {cfg.model.output_size} px: params bf16, Adam "
            "mu f32, the checkpoint restores bit for bit")
    # the bf16 policy at 128 px on the same state and inputs: its routes
    # within the bf16 limits, and its step not the fp8 step
    bcfg = timed["kernel_bf16_128px"] = dataclasses.replace(
        pcfg, precision="bf16")
    bgrads, bm, _ = a1_route_grads(torch, "kernel_bf16_128px", bcfg, report)
    policy_gap = net_gaps(convert, grads, bgrads, pre_bn_biases(bcfg.model))
    if bm == losses or not min(policy_gap.values()) > 0.0:
        fail(f"a1 fp8 at 128 px: the bf16 step's losses {bm}, fp8's "
             f"{losses}; gradients off the bf16 step's by {policy_gap} "
             "(relative L2)")
    report["fp8_vs_bf16_128px"] = {"losses": [losses, bm],
                                   "net_grad_gap": policy_gap}
    log(f"a1 fp8 at 128 px differs from the bf16 step: losses {losses} vs "
        f"{bm}; each net's gradient off the bf16 step's by {policy_gap}, "
        f"off the cuDNN route's fp8 step's by {route_gap} (relative L2)")
    a1_fp8_stages(torch, report)
    # the quantizer on the card against the CPU, bit for bit, at G's
    # largest patch matrix of a 64 px model
    x = torch.randn((BATCH * 32 * 32, 25 * 128), device="cuda",
                    dtype=torch.bfloat16) * 3.0
    if not torch.equal(fake_quant_fp8(x).cpu(), fake_quant_fp8(x.cpu())):
        fail("fake_quant_fp8 on the card differs from the CPU's")
    log("a1 fp8: fake_quant_fp8 on the card equals the CPU's bit for bit")

    # 5. kernel 5's backward
    check_gbsa_backward(torch, report)

    # 6. the penalty on a kernel route is refused
    try:
        TrainConfig(model=ModelConfig(use_pallas=True, pallas_fused=True),
                    loss="wgan-gp")
    except NotImplementedError as e:
        log(f"a1: wgan-gp with use_pallas refused: {e}")
    else:
        fail("a1: loss='wgan-gp' with use_pallas was not refused")

    # 7. timings
    timed.update({"wgan_gp": capture_cfg("wgan-gp", {}), "r1_lazy": r1_cfg,
                  "kernel_critic": kcfg})
    for name, tcfg in timed.items():
        a1_timed(torch, name, tcfg, report["timed"])
    pcfg = get_preset("wgan-gp", batch_size=BATCH)
    fns = make_train_step(pcfg)
    st = fns.init(seed=SEED, device="cuda")
    images, zs, _ = a1_inputs(torch, pcfg, 1)
    for label, fn in (("eval_losses", lambda: fns.eval_losses(
            st, images[0], zs[0])), ("summarize", lambda: fns.summarize(
                st, images[0], zs[0]))):
        dev_ms, call_ms = time_ms(torch, fn, 5, warmup=1,
                                  label=f"wgan-gp {label}")
        report[label] = {"device_ms": dev_ms, "call_ms": call_ms}
        log(f"a1 wgan-gp {label}: {dev_ms:.3f} ms on the card, "
            f"{call_ms:.3f} ms host-inclusive per call")
    return report


# ---------------------------------------------------------------------------
# the native feed, the pipelined G/D step, the NaN gate (`feed_pipeline`)
# ---------------------------------------------------------------------------

# uint8 64x64x3 records written for the group (the wire format prepare.py
# writes by default), in shards
FEED_RECORDS = 2048
FEED_SHARDS = 8
# steps of each train() run on a feed (the p50 of its step times is
# read from events.jsonl)
FEED_TRAIN_STEPS = 16
# eager against captured pipelined steps, the pipeline drained before
# step PIPE_DRAIN_AT (a refill, as after a restore)
PIPE_COMPARE_STEPS = 6
PIPE_DRAIN_AT = 3
# steps of the pipelined train() run whose launches are counted
PIPE_TRAIN_STEPS = 4


def pipe_per_stage(n_critic, accum, stages=3):
    """Kernel launches of each stage program of the kernel route
    (pipeline_gd), derived as `a1_per_step`: gen_fakes is n_critic G
    forwards (1 channel_moments, s + 1 scale_shift_act, s
    gemm_bias_moments each); d_update per critic update and microbatch D
    on the real and the fake batch and its backward (2s, 2s, 2s); g_update
    per microbatch G's forward, D on the fake batch and the backward
    through both (as in the fused step), then n_critic - 1 G forwards for
    the next stack's other slots. A steady step (d_update + g_update) at
    (1, 1, 3) is PER_STEP less one G forward: slot 0 of the next stack is
    the G-loss forward's own images."""
    n, k, s = n_critic, accum, stages
    zero = dict.fromkeys(PER_STEP, 0)
    return {
        "gen_fakes": dict(zero, channel_moments=n,
                          scale_shift_act=n * (s + 1),
                          gemm_bias_moments=n * s),
        "d_update": dict(zero, scale_shift_act=k * n * 2 * s,
                         scale_shift_act_bwd=k * n * 2 * s,
                         gemm_bias_moments=k * n * 2 * s),
        "g_update": dict(zero, channel_moments=k + n - 1,
                         scale_shift_act=k * (2 * s + 1) + (n - 1) * (s + 1),
                         scale_shift_act_bwd=k * (2 * s + 1),
                         gemm_bias_moments=k * 2 * s + (n - 1) * s)}


def feed_train(torch, np, cfg, synthetic, steps):
    """train() for `steps` steps on one feed: (p50 and mean host-inclusive
    ms per step of the last logged window, seconds of the call)."""
    from dcgan_tpu_torch.train import trainer

    t0 = time.perf_counter()
    state = trainer.train(cfg, synthetic_data=synthetic, max_steps=steps,
                          device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if int(state["step"]) != steps:
        fail(f"feed_pipeline: train() ended at step {int(state['step'])}")
    with open(os.path.join(cfg.checkpoint_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(1, steps + 1)) or not all(
            np.isfinite(r["values"]["d_loss"]) for r in rows):
        fail(f"feed_pipeline: events.jsonl of {cfg.checkpoint_dir}: "
             f"{[(r['step'], r['values'].get('d_loss')) for r in rows]}")
    last = rows[-1]["values"]
    return last["perf/step_ms_p50"], last["perf/step_ms_mean"], secs


def pipe_compare(torch, cfg, report):
    """PIPE_COMPARE_STEPS pipelined steps eager (a GDPipeline over the step
    functions) against the runner's captured stage rows, from the seeded
    state on the same images and draws, the pipeline drained before step
    PIPE_DRAIN_AT in both, cuDNN deterministic: every metric and state
    leaf equal bit for bit, two fills each; each stage row's launches of
    kernels 1-4 as `pipe_per_stage` and its graph pool bytes."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train import trainer
    from dcgan_tpu_torch.train.gd_pipeline import GDPipeline
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import STAGE_ROWS, StepRunner

    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fns = make_train_step(cfg)
        images, _ = step_inputs(torch, cfg, PIPE_COMPARE_STEPS)
        draws = [trainer.stage_inputs(cfg, s, dev)
                 for s in range(PIPE_COMPARE_STEPS)]
        runner = StepRunner(fns, fns.init(seed=SEED, device=dev), cfg, dev)
        keys = runner.keys
        state, pipe, eager = fns.init(seed=SEED, device=dev), GDPipeline(), []
        for s in range(PIPE_COMPARE_STEPS):
            if s == PIPE_DRAIN_AT:
                pipe.drain("restore")
            state, m = pipe.step(fns, state, images[s], draws[s])
            eager.append([float(m[k]) for k in keys])
        got = []
        for s in range(PIPE_COMPARE_STEPS):
            if s == PIPE_DRAIN_AT:
                runner.pipeline.drain("restore")
            got += runner.pipelined_step(images[s], draws[s],
                                         start=s).tolist()
        if got != eager:
            fail(f"pipeline_gd: captured steps {got} differ from eager "
                 f"{eager}")
        leaves = same_state(torch, convert, "pipeline_gd captured vs eager",
                            runner.state, state)
        if sorted(runner.programs) != sorted(STAGE_ROWS) or \
                (pipe.fills, runner.pipeline.fills) != (2, 2):
            fail(f"pipeline_gd: programs {sorted(runner.programs)}, fills "
                 f"{pipe.fills} eager, {runner.pipeline.fills} captured")
        want = pipe_per_stage(cfg.n_critic, cfg.grad_accum)
        stages = {}
        for name in STAGE_ROWS:
            prog = runner.programs[name]
            launches = {k: n for k, (n, _) in prog.launches.items()}
            if launches != want[name]:
                fail(f"pipeline_gd {name}: launches {launches}, expected "
                     f"{want[name]}")
            stages[name] = {"launches": launches,
                            "pool_bytes": prog.pool_bytes,
                            "capture_ms": prog.capture_ms}
        log(f"pipeline_gd: {PIPE_COMPARE_STEPS} captured pipelined steps "
            f"(fill, steady, a drain and a refill at step {PIPE_DRAIN_AT}) "
            f"equal the eager GDPipeline bit for bit ({leaves} leaves); "
            "per stage: " + "; ".join(
                f"{n} {st['launches']} pool {st['pool_bytes']} B"
                for n, st in stages.items()))
        report["stages"] = stages
        runner.close()
        del runner
    finally:
        torch.backends.cudnn.deterministic = saved


def pipe_timed(torch, cfg, report):
    """One pipelined step (its two stage rows, steady) against one fused
    step of the same config at K=1, host-inclusive ms, busy ms and idle
    share, in turns (pipelined, fused, fused, pipelined)."""
    from dcgan_tpu_torch.train import trainer
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    dev = torch.device("cuda", torch.cuda.current_device())
    fcfg = dataclasses.replace(cfg, pipeline_gd=False)
    images, _ = step_inputs(torch, cfg, 2)
    draws = [trainer.stage_inputs(cfg, s, dev) for s in range(2)]
    z, fd = trainer.step_inputs(fcfg, 1, dev)
    rp = StepRunner(make_train_step(cfg), make_train_step(cfg).init(
        seed=SEED, device=dev), cfg, dev)
    ffns = make_train_step(fcfg)
    rf = StepRunner(ffns, ffns.init(seed=SEED, device=dev), fcfg, dev)
    rp.pipelined_step(images[0], draws[0], start=0)
    rf.step([images[0]], [z], [fd], start=0)

    def piped():
        rp.pipelined_step(images[1], draws[1], start=1).tolist()

    def fused():
        rf.step([images[1]], [z], [fd], start=1).tolist()

    def turn(fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS // 4):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / (TIMED_STEPS // 4)
        split = profile_split(torch, fn, steps=PROFILED_CALLS, settle=True)
        if split is None:
            return {"step_ms": ms, "busy_ms": "not measured",
                    "idle_share": "not measured"}
        return {"step_ms": ms, "busy_ms": split["busy_ms"],
                "idle_share": split["idle_share"],
                "launches_per_step": split["launches_per_step"]}
    turns = {"pipelined": [], "fused": []}
    for label in ("pipelined", "fused", "fused", "pipelined"):
        turns[label].append(turn(piped if label == "pipelined" else fused))
    report["timed"] = turns
    report["pool_bytes"] = {
        "pipelined": {n: p.pool_bytes for n, p in rp.programs.items()},
        "fused": {n: p.pool_bytes for n, p in rf.programs.items()}}
    log("pipeline_gd vs fused, one step at K=1, host-inclusive ms / busy "
        "ms / idle share in turns: " + "; ".join(
            f"{label} " + ", ".join(
                f"{t['step_ms']:.3f} / {t['busy_ms']} / {t['idle_share']}"
                for t in runs) for label, runs in turns.items()))
    rp.close()
    rf.close()
    del rp, rf


def feed_pipeline_and_check(torch, np, workdir, kernels):
    """Phase 16: the native loader against the Python one on the host
    alone (float64 and uint8 records at 64 px); train() on the native
    uint8 feed against the synthetic feed, kernel and cuDNN routes,
    captured at K=1; pipeline_gd on the kernel route (captured = eager bit
    for bit over fills and steady steps, launches per stage, ms against
    the fused step, one train() run ending in one drain, its launches the
    kernels' `pipeline_gd` path); the NaN gate on the card; fake_quant_fp8's
    Function against its composed ops on the card. Returns the report."""
    import dataclasses as dc

    from dcgan_tpu_torch.data.synthetic import write_image_tfrecords
    from dcgan_tpu_torch.ops.layers import fake_quant_fp8, \
        fake_quant_fp8_ops
    from dcgan_tpu_torch.presets import celeba64 as celeba64_preset
    from dcgan_tpu_torch.train import trainer
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    root = os.path.join(workdir, "feed")
    base = celeba64_preset()
    kernel_model = dc.replace(base.model, use_pallas=True, pallas_fused=True)
    u8 = dc.replace(base, batch_size=BATCH, seed=SEED, record_dtype="uint8",
                    data_dir=os.path.join(root, "u8"),
                    shuffle_buffer=RESUME_SHUFFLE, sample_every_steps=0,
                    activation_summary_steps=0, save_model_secs=1e9,
                    tensorboard=False)
    report = {"records": FEED_RECORDS, "batch": BATCH}

    # 1. the loaders on the host alone
    t0 = time.perf_counter()
    write_image_tfrecords(u8.data_dir, num_examples=FEED_RECORDS,
                          image_size=64, channels=3, num_shards=FEED_SHARDS,
                          record_dtype="uint8", seed=SEED)
    report["write_uint8_s"] = time.perf_counter() - t0
    f64 = dc.replace(u8, data_dir=os.path.join(workdir, "resume", "data"),
                     record_dtype="float64")
    loaders = report["loaders"] = {}
    for dtype, cfg in (("float64", f64), ("uint8", u8)):
        for kind in ("native", "python"):
            first, rate = loader_rate(cfg, native=kind == "native")
            loaders[f"{kind} {dtype}"] = {"first_batch_s": first,
                                          "images_per_s": rate}
    log("feed_pipeline: loaders on the host alone "
        f"({u8.num_loader_threads} readers, pool {u8.shuffle_buffer}, batch "
        f"{BATCH}), first batch s / images/s after it: " + "; ".join(
            f"{k} {v['first_batch_s']:.3f} / {v['images_per_s']:.0f}"
            for k, v in loaders.items()))

    # 2. train() on the native uint8 feed and on the synthetic feed, each
    # route at K=1; the idle share through the trainer's feed and runner
    feeds = report["feeds"] = {}
    for route, model in (("kernel", kernel_model), ("cudnn", base.model)):
        for feed in ("native uint8", "synthetic"):
            run = os.path.join(root, f"{route}_{feed.replace(' ', '_')}")
            cfg = dc.replace(u8, model=model, checkpoint_dir=run,
                             sample_dir=os.path.join(run, "samples"))
            synthetic = feed == "synthetic"
            p50, mean, secs = feed_train(torch, np, cfg, synthetic,
                                         FEED_TRAIN_STEPS)
            fns = make_train_step(cfg)
            ms, split = feed_steps_captured(torch, trainer, fns, cfg,
                                            synthetic, 1)
            feeds[f"{route} {feed}"] = {
                "train_step_ms_p50": p50, "train_step_ms_mean": mean,
                "train_s": secs, "runner_step_ms": ms,
                "idle_share": split["idle_share"] if split
                else "not measured",
                "busy_ms": split["busy_ms"] if split else "not measured"}
    log("feed_pipeline: celeba64 train() at K=1, host-inclusive ms per step "
        "(p50 of events.jsonl) / the runner on the same feed / busy ms / "
        "idle share: " + "; ".join(
            f"{k} {v['train_step_ms_p50']:.3f} / {v['runner_step_ms']:.3f} "
            f"/ {v['busy_ms']} / {v['idle_share']}"
            for k, v in feeds.items()))

    # 3. pipeline_gd on the kernel route
    pcfg = dc.replace(u8, model=kernel_model, pipeline_gd=True,
                      checkpoint_dir=os.path.join(root, "pipe"),
                      sample_dir=os.path.join(root, "pipe", "samples"))
    pipe = report["pipeline_gd"] = {}
    pipe_compare(torch, pcfg, pipe)
    pipe_timed(torch, pcfg, pipe)
    seen = []
    real_close = StepRunner.close

    def close(self):
        if self.pipeline is not None:
            seen.append((self.pipeline.fills, self.pipeline.drains,
                         self.pipeline.last_drain_reason))
        real_close(self)
    wrappers = all_wrappers()
    reset_counts(wrappers)
    StepRunner.close = close
    try:
        state = trainer.train(pcfg, max_steps=PIPE_TRAIN_STEPS,
                              device="cuda")
    finally:
        StepRunner.close = real_close
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    per = pipe_per_stage(1, 1)
    want = {k: PIPE_TRAIN_STEPS * (per["d_update"][k] + per["g_update"][k])
            + per["gen_fakes"][k] for k in PER_STEP}
    if launches != want:
        fail(f"pipeline_gd train(): launches {launches}, expected {want}")
    if seen != [(1, 1, "shutdown")] or int(state["step"]) != \
            PIPE_TRAIN_STEPS or Checkpointer(
                pcfg.checkpoint_dir).latest_step() != PIPE_TRAIN_STEPS:
        fail(f"pipeline_gd train(): (fills, drains, reason) {seen}, step "
             f"{int(state['step'])}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["pipeline_gd"] = \
            launches[entry["name"]]
        entry["launches_by_stage"] = {n: c[entry["name"]]
                                      for n, c in per.items()}
    pipe["train_launches"] = launches
    log(f"pipeline_gd: train() from the native uint8 feed, "
        f"{PIPE_TRAIN_STEPS} steps, one fill and one drain ('shutdown'), "
        f"launches {launches}")

    # 4. the NaN gate on the card: a NaN learning rate trips it at step 1
    ncfg = dc.replace(u8, model=kernel_model, learning_rate=float("nan"),
                      nan_check_steps=1,
                      checkpoint_dir=os.path.join(root, "nan"),
                      sample_dir=os.path.join(root, "nan", "samples"))
    try:
        trainer.train(ncfg, synthetic_data=True, max_steps=3, device="cuda")
    except FloatingPointError as e:
        if getattr(e, "step", None) != 1 or "step 1" not in str(e):
            fail(f"the NaN gate tripped at the wrong step: {e}")
        report["nan_gate"] = str(e)
        log(f"feed_pipeline: the NaN gate raised FloatingPointError: {e}")
    else:
        fail("a NaN learning rate trained 3 steps without the NaN gate "
             "tripping")
    if Checkpointer(ncfg.checkpoint_dir).latest_step() is not None:
        fail("the NaN gate let the poisoned state be checkpointed")

    # 5. fake_quant_fp8's Function against its composed ops on the card
    x = torch.randn((BATCH * 16 * 16, 25 * 128), device="cuda",
                    dtype=torch.bfloat16) * 3.0
    gy = torch.randn_like(x)
    out = []
    for fn in (fake_quant_fp8, fake_quant_fp8_ops):
        xr = x.clone().requires_grad_(True)
        y = fn(xr)
        (g,) = torch.autograd.grad(y, xr, gy)
        out.append((y.detach(), g))
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])):
        fail("fake_quant_fp8's Function differs from its composed ops on "
             "the card")
    log("feed_pipeline: fake_quant_fp8's Function equals its composed ops "
        "on the card, output and cotangent, bit for bit")
    del x, gy, out
    return report


# the serving fleet (`serve_fleet`)
FLEET_REQUESTS = 256
# the demo load's Poisson rate: at 4.5 images a request on average, above
# what one replica of the kernel route serves (so samples/s is the
# plane's, not the load's)
FLEET_RPS = 4000
FLEET_REPLICAS = 2
# the failover check: one replica's source raises at its FLEET_FAIL_AT-th
# dispatch; FLEET_FAILOVER_REQUESTS requests go in waves of
# FLEET_FAILOVER_WAVE, each a new client, so both replicas dispatch in
# every wave
FLEET_FAIL_AT = 3
FLEET_FAILOVER_REQUESTS = 48
FLEET_FAILOVER_WAVE = 8
# the artifact's rungs timed against the kernel route's and the cuDNN
# route's
FLEET_TIMED_RUNGS = (1, 8, 64)


@contextlib.contextmanager
def rung_pools():
    """Records {source: graph pool bytes of its rungs} of every source the
    serving plane closes inside the block (the pools are gone after)."""
    from dcgan_tpu_torch.serve import sources

    pools = {}
    original = sources._RungSource.close

    def close(self):
        pools[self] = sum(prog.pool_bytes for *_, prog in
                          self._rungs.values())
        original(self)

    sources._RungSource.close = close
    try:
        yield pools
    finally:
        sources._RungSource.close = original


def graph_pool_segments(torch):
    """Segments of CUDA graph private pools still reserved, after the
    cache is emptied and without a garbage collection."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) != (0, 0)]


def promoted_step(torch, np, src_dir, dst_dir, step):
    """Writes `step` into `dst_dir` through the Checkpointer, as a trainer
    would: the newest state of `src_dir` with G's weights changed (scaled
    and shifted by seeded noise). Returns the new G params (host)."""
    from dcgan_tpu_torch.config import load_config
    from dcgan_tpu_torch.train.steps import init_train_state, tree_map
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    state = Checkpointer(src_dir).restore_latest(init_train_state(
        load_config(src_dir), device="cpu"))
    rng = np.random.default_rng(SEED + 7)
    state["params"]["gen"] = tree_map(
        lambda w: w * 1.25 + torch.from_numpy(rng.normal(
            0.0, 0.05, tuple(w.shape)).astype(np.float32)).to(w.dtype),
        state["params"]["gen"])
    state["step"] = torch.tensor(step, dtype=torch.int32)
    ckpt = Checkpointer(dst_dir)
    ckpt.save(step, state)
    ckpt.wait()
    return state["params"]["gen"]


def fleet_client(fleet, stop, out):
    """Submits seeded requests of 1-8 images to `fleet` until `stop`,
    appending (seed, n, Response) to `out`."""
    i = 0
    while not stop.is_set():
        n = 1 + i % 8
        out.append((SEED + 1000 + i, n, fleet.submit(
            n, seed=SEED + 1000 + i, client_id=i % 4)))
        i += 1
        time.sleep(0.001)


def request_failed(r, timeout=60.0):
    """Whether a Response failed (waits for it)."""
    try:
        r.result(timeout=timeout)
    except Exception:
        return True
    return False


def serve_fleet_and_check(torch, np, workdir, kernels):
    """Phase 17: the serving fleet on the resume group's celeba64
    kernel-route checkpoint. Returns the `serve_fleet` report."""
    import shutil

    from dcgan_tpu_torch.config import load_config
    from dcgan_tpu_torch.convert import flatten
    from dcgan_tpu_torch.export import export_sampler
    from dcgan_tpu_torch.graphs import counts_delta, launch_counts
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve import __main__ as serve_main
    from dcgan_tpu_torch.serve.buckets import build_ladder
    from dcgan_tpu_torch.serve.fleet import ServeFleet
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import ArtifactSource, \
        CheckpointSource, StateSource, latest_finalized_step

    root = os.path.join(workdir, "serve_fleet")
    run = os.path.join(root, "run")
    old = os.path.join(root, "old")
    for dst in (run, old):
        # a copy: the resume group marked its newest step corrupt
        shutil.copytree(os.path.join(workdir, "resume", "run"), dst,
                        ignore=shutil.ignore_patterns("*.corrupt*"))
    cfg = load_config(run)
    mcfg = cfg.model
    if not (mcfg.use_pallas and mcfg.pallas_fused):
        fail(f"serve_fleet: {run} is not a kernel-route checkpoint")
    step0 = latest_finalized_step(run)
    report = {"checkpoint_step": step0, "requests": FLEET_REQUESTS,
              "demo_rps": FLEET_RPS}
    # bit-for-bit comparisons below: the sources' cuDNN convolutions take
    # the deterministic algorithms
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    wrappers = all_wrappers()
    reset_counts(wrappers)

    # 1. the same demo load on one replica and on FLEET_REPLICAS
    runs = report["fleet_vs_bare"] = {}
    for n in (1, FLEET_REPLICAS):
        argv = ["--checkpoint_dir", run, "--device", "cuda", "--fleet",
                str(n), "--max_batch", str(BATCH), "--demo_requests",
                str(FLEET_REQUESTS), "--demo_rps", str(FLEET_RPS),
                "--demo_max_images", "8", "--seed", str(SEED)]
        with rung_pools() as pools:
            row, responses = serve_main.run(argv)
        if row["completed"] != FLEET_REQUESTS or row["failed"] or \
                row["serve/dropped"] or row["serve/recompiles_after_warmup"]:
            fail(f"serve_fleet --fleet {n}: {row['completed']} completed, "
                 f"{row['failed']} failed, {row['serve/dropped']} dropped, "
                 f"{row['serve/recompiles_after_warmup']} recaptures")
        for r in responses:
            img = r.result(timeout=0)
            if not np.isfinite(img).all() or np.abs(img).max() > 1.0:
                fail(f"serve_fleet --fleet {n}: images not finite or "
                     "outside [-1, 1]")
        # the report's samples/s counts from the first replica's warm
        # time (the JAX formula), so a fleet's includes the later
        # replicas' cold starts; the load window's: the images over the
        # span from the first arrival to the last completion, each
        # request submitted at its scheduled arrival
        arrivals = serve_main._load_arrivals(
            serve_main.build_parser().parse_args(argv))
        span_ms = max(a["t_ms"] + r.meta["total_ms"]
                      for a, r in zip(arrivals, responses)) \
            - arrivals[0]["t_ms"]
        images = sum(r.images.shape[0] for r in responses)
        runs[f"replicas_{n}"] = {
            "p50_ms": row["serve/p50_ms"], "p99_ms": row["serve/p99_ms"],
            "samples_per_sec": row["serve/samples_per_sec"],
            "load_samples_per_sec": images / (span_ms / 1e3),
            "pad_frac": row["serve/pad_frac"],
            "batches": row["serve/batches"],
            "cold_start_ms": [r["serve/cold_start_ms"]
                              for r in row["fleet"]["per_replica"]],
            "graph_pool_bytes": sorted(pools.values())}
        log(f"serve_fleet: {FLEET_REQUESTS} requests at {FLEET_RPS}/s on "
            f"{n} replica(s): p50 {row['serve/p50_ms']:.3f} ms, p99 "
            f"{row['serve/p99_ms']:.3f} ms, {row['serve/samples_per_sec']:.1f}"
            f" samples/s (report), "
            f"{runs[f'replicas_{n}']['load_samples_per_sec']:.1f} over the "
            f"load window, pad_frac {row['serve/pad_frac']:.4f}, "
            f"{row['serve/batches']:.0f} batches; cold start ms "
            f"{runs[f'replicas_{n}']['cold_start_ms']}, graph pool bytes "
            f"per replica {runs[f'replicas_{n}']['graph_pool_bytes']}")

    # 2. promotion by the watcher while a client submits, then failover;
    # without the collector, so that the pools' release is stop()'s own
    z = np.random.default_rng(SEED + 3).uniform(
        -1.0, 1.0, (BATCH, mcfg.z_dim)).astype(np.float32)
    collecting = gc.isenabled()
    gc.disable()
    try:
        srcs = [CheckpointSource(run, device="cuda")
                for _ in range(FLEET_REPLICAS)]
        fleet = ServeFleet(srcs, max_batch=BATCH, max_wait_ms=1.0,
                           watch_promotions=True, watch_interval_secs=0.05)
        fleet.start()
        ptrs = [{k: v.data_ptr() for k, v in
                 flatten({"p": s._params, "s": s._state}).items()}
                for s in srcs]
        before = fleet.submit(z=z).result(timeout=60)
        stop, client = threading.Event(), []
        thread = threading.Thread(target=fleet_client,
                                  args=(fleet, stop, client))
        thread.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        new_gen = promoted_step(torch, np, old, run, step0 + 1)
        report["save_s"] = time.perf_counter() - t0
        deadline = time.monotonic() + 60.0
        while not fleet.promotion_results and time.monotonic() < deadline:
            time.sleep(0.01)
        report["promotion_seen_s"] = time.perf_counter() - t0
        time.sleep(0.1)
        stop.set()
        thread.join(60)
        if not fleet.promotion_results:
            fail("serve_fleet: the watcher promoted nothing in 60 s")
        results = fleet.promotion_results[0]
        # the client's requests resolve first: `after` must be a batch of
        # its own, on the b64 rung that the fresh source's check replays
        # (a 64-row request behind queued ones is chunked over two rungs,
        # whose convolutions may sum in another order)
        failed = [seed for seed, _, r in client if request_failed(r)]
        after_r = fleet.submit(z=z)
        after = after_r.result(timeout=60)
        if after_r.meta["buckets"] != [BATCH]:
            fail(f"serve_fleet: the request after the promotion ran on "
                 f"rungs {after_r.meta['buckets']}, not one of {BATCH}")
        if [(r.get("step"), r.get("compile_requests_delta"))
                for r in results] != [(step0 + 1, 0)] * FLEET_REPLICAS:
            fail(f"serve_fleet: promotion results {results}")
        if [{k: v.data_ptr() for k, v in
             flatten({"p": s._params, "s": s._state}).items()}
                for s in srcs] != ptrs:
            fail("serve_fleet: a promotion moved a served leaf")
        promo = fleet.report()
        if failed or promo["serve/dropped"] or \
                promo["serve/recompiles_after_warmup"]:
            fail(f"serve_fleet: promotion under load failed requests "
                 f"{failed[:5]}, dropped {promo['serve/dropped']}, "
                 f"{promo['serve/recompiles_after_warmup']} recaptures")
        report["promotion"] = {
            "swap_ms": [r["swap_ms"] for r in results],
            "stage_ms": [r.get("stage_ms") for r in results],
            "client_requests": len(client),
            "promote_swap_ms": promo["serve/promote_swap_ms"]}
        log(f"serve_fleet: the watcher promoted step {step0 + 1} on "
            f"{FLEET_REPLICAS} replicas while a client submitted "
            f"{len(client)} requests: swap ms per replica "
            f"{report['promotion']['swap_ms']} (the restore staged "
            f"beforehand on the watcher's thread, ms "
            f"{report['promotion']['stage_ms']}), 0 captures, every leaf's "
            f"data_ptr unchanged, 0 failed or dropped (save "
            f"{report['save_s']:.3f} s, seen after "
            f"{report['promotion_seen_s']:.3f} s)")

        # failover: one replica's source raises at its FLEET_FAIL_AT-th
        # dispatch from here on
        victim = srcs[-1]
        calls = [0]
        real_sample = victim.sample

        def sample(bucket, zz, labels=None):
            calls[0] += 1
            if calls[0] == FLEET_FAIL_AT:
                raise RuntimeError("serve_fleet: a replica fails on purpose")
            return real_sample(bucket, zz, labels)
        victim.sample = sample
        fo_failed = 0
        for lo in range(0, FLEET_FAILOVER_REQUESTS, FLEET_FAILOVER_WAVE):
            wave = [fleet.submit(1 + i % 8, seed=SEED + 5000 + i,
                                 client_id=f"failover{i}")
                    for i in range(lo, lo + FLEET_FAILOVER_WAVE)]
            fo_failed += sum(1 for r in wave if request_failed(r))
        fleet.router.poll_health()
        fleet.stop()
        rep = fleet.report()
        if fo_failed or rep["serve/fleet_unhealthy"] != 1 or \
                rep["serve/fleet_failovers"] < 1 or \
                rep["serve/dropped_failover"] or len(fleet.stop_errors) != 1:
            fail(f"serve_fleet failover: {fo_failed} failed requests, "
                 f"unhealthy {rep['serve/fleet_unhealthy']}, failovers "
                 f"{rep['serve/fleet_failovers']}, dropped_failover "
                 f"{rep['serve/dropped_failover']}, stop errors "
                 f"{fleet.stop_errors}")
        report["failover"] = {"requests": FLEET_FAILOVER_REQUESTS,
                              "failed": fo_failed,
                              "failovers": rep["serve/fleet_failovers"],
                              "unhealthy": rep["serve/fleet_unhealthy"]}
        log(f"serve_fleet: replica {FLEET_REPLICAS - 1} raised at "
            f"its dispatch {FLEET_FAIL_AT}; {FLEET_FAILOVER_REQUESTS} "
            f"requests, 0 failed, {rep['serve/fleet_failovers']:.0f} failed "
            "over, serve/fleet_unhealthy 1")
        left = graph_pool_segments(torch)
        report["graph_pool_bytes_after_stop"] = sum(
            seg["total_size"] for seg in left)
        if left:
            fail(f"serve_fleet: {len(left)} graph pool segments "
                 f"({report['graph_pool_bytes_after_stop']} bytes) left "
                 "after ServeFleet.stop(), before any collection")
        log("serve_fleet: ServeFleet.stop() released every graph pool "
            "before any garbage collection (0 segments)")
        del fleet, srcs, victim, real_sample, sample
    finally:
        if collecting:
            gc.enable()

    # 3. int8 on one server
    qsrc = CheckpointSource(run, quantize="int8", device="cuda")
    server = SamplerServer(qsrc, max_batch=BATCH, max_wait_ms=1.0)
    meta = server.start()
    q_images = server.submit(z=z).result(timeout=60)
    server.stop()
    launches = {name: fn.launches for name, fn in wrappers.items()}

    served = ("scale_shift_act", "gemm_bias_scale_act")
    for name in served:
        if launches[name] < 1:
            fail(f"serve_fleet: kernel {name} was not launched")
    for name in TRAIN_ONLY + tuple(FLASH_REPLACES):
        if launches[name]:
            fail(f"serve_fleet: the sampler launched {name}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["serve_fleet"] = \
            launches[entry["name"]]
    report["launches"] = launches
    log(f"serve_fleet path launches: {launches}")

    # 4. the checks against fresh sources (their launches do not count)
    new_src = CheckpointSource(run, device="cuda")
    old_src = CheckpointSource(old, device="cuda")
    ladder = build_ladder(BATCH).buckets
    for src in (new_src, old_src):
        src.prepare()
        src.bind(ladder)
    want = new_src.sample(BATCH, z)
    if not np.array_equal(after, want):
        fail(f"serve_fleet: images after the promotion differ from a fresh "
             f"source on step {step0 + 1}: max |err| "
             f"{float(np.abs(after - want).max())}")
    if not np.array_equal(before, old_src.sample(BATCH, z)):
        fail("serve_fleet: images before the promotion differ from the "
             f"fresh source on step {step0}")
    moved = float(np.abs(after - before).max())
    if moved < 4 * SERVED_TOL:
        fail(f"serve_fleet: the new step moved the images by {moved} only: "
             "old and new weights cannot be told apart")
    # every response the client got is wholly the old or the new weights'
    # (a request chunked over two batches may be both: skipped)
    counts = {"old": 0, "new": 0, "chunked": 0}
    for seed, n, r in client:
        if len(r.meta["buckets"]) > 1:
            counts["chunked"] += 1
            continue
        (bucket,) = r.meta["buckets"]
        rows = np.zeros((bucket, mcfg.z_dim), np.float32)
        rows[:n] = np.random.default_rng(seed).uniform(
            -1.0, 1.0, (n, mcfg.z_dim))
        errs = {k: float(np.abs(s.sample(bucket, rows)[:n]
                                - r.images).max())
                for k, s in (("old", old_src), ("new", new_src))}
        best = min(errs, key=errs.get)
        if errs[best] > SERVED_TOL:
            fail(f"serve_fleet: response {seed} matches neither weights "
                 f"({errs}): a replay read half-copied weights")
        counts[best] += 1
    report["promotion"]["responses_old_new"] = counts
    log(f"serve_fleet: images after the promotion equal a fresh source on "
        f"step {step0 + 1} bit for bit (moved {moved:.3f} from before); "
        f"the client's responses: {counts['old']} on the old weights, "
        f"{counts['new']} on the new, none mixed ({counts['chunked']} "
        "chunked over two batches, not checked)")
    q_err = float(np.abs(q_images - want).max())
    q_mean = float(np.abs(q_images - want).mean())
    # the JAX package's committed bound on the weights' relative error
    if not np.isfinite(q_images).all() or \
            not 0 < meta["quantize"]["max_rel_error"] < 0.02:
        fail(f"serve_fleet int8: report {meta['quantize']}, images finite "
             f"{bool(np.isfinite(q_images).all())}")
    report["int8"] = {"max_rel_error": meta["quantize"]["max_rel_error"],
                      "worst_leaf": meta["quantize"]["worst_leaf"],
                      "max_abs_image_diff": q_err,
                      "mean_abs_image_diff": q_mean}
    log(f"serve_fleet int8: {meta['quantize']['quantized_leaves']} leaves, "
        f"max relative weight error {meta['quantize']['max_rel_error']} "
        f"({meta['quantize']['worst_leaf']}); images against the f32 "
        f"weights, same z: max |diff| {q_err:.4f}, mean {q_mean:.5f}")

    # 5. the artifact: exported on the card, served on captured rungs
    t0 = time.perf_counter()
    art = os.path.join(root, "sampler.pt2")
    side = export_sampler(run, art, device="cuda", max_serve_batch=BATCH)
    report["export_s"] = time.perf_counter() - t0
    asrc = ArtifactSource(art, device="cuda")
    server = SamplerServer(asrc, max_wait_ms=1.0)
    server.start()
    a_images = server.submit(z=z).result(timeout=60)
    if asrc.compiled_buckets() != ladder:
        fail(f"serve_fleet artifact: rungs {asrc.compiled_buckets()}")
    plain = dataclasses.replace(mcfg, use_pallas=False, pallas_fused=False)
    ref = sampler_apply(new_src._params, new_src._state,
                        torch.from_numpy(z).cuda(), cfg=plain)
    a_err = float(np.abs(a_images - ref.float().cpu().numpy()).max())
    if not np.isfinite(a_images).all() or a_err > SERVED_TOL:
        fail(f"serve_fleet artifact: images differ from the plain-route "
             f"sampler by {a_err} > {SERVED_TOL}")
    cudnn_src = StateSource(plain, new_src._params, new_src._state,
                            device="cuda")
    cudnn_src.bind(FLEET_TIMED_RUNGS)
    timed = {}
    for b in FLEET_TIMED_RUNGS:
        for name, src in (("artifact", asrc), ("kernel_route", new_src),
                          ("cudnn_route", cudnn_src)):
            prog = src._rungs[b][-1]
            timed[f"{name}@b{b}"], _ = time_ms(
                torch, prog.run, 30, label=f"serve_fleet {name} rung b{b}")
    server.stop()
    report["artifact"] = {"bytes": side["bytes"], "max_abs_err": a_err,
                          "rung_ms": timed}
    log(f"serve_fleet artifact: {side['bytes']} bytes, exported in "
        f"{report['export_s']:.2f} s, images within {a_err:.4g} of the "
        f"plain-route sampler; captured rung ms (artifact / kernel route "
        f"/ cuDNN route): " + "; ".join(
            f"b{b} {timed[f'artifact@b{b}']:.4f} / "
            f"{timed[f'kernel_route@b{b}']:.4f} / "
            f"{timed[f'cudnn_route@b{b}']:.4f}" for b in FLEET_TIMED_RUNGS))
    for src in (new_src, old_src, cudnn_src):
        src.close()
    torch.backends.cudnn.deterministic = deterministic
    return report


# ---------------------------------------------------------------------------
# class conditioning (cifar10-cond), dcgan128 and sagan128 (`conditional`)
# ---------------------------------------------------------------------------

# the fake CIFAR-10 python batches (data_batch_1..5, 32x32x3 uint8 rows
# and labels) that `prepare --cifar10` turns into labelled shards
COND_ROWS = 256
COND_SHARDS = 4
COND_STEPS = 6
# the conditional-BN steps, captured at K=1 against eager
COND_CAPTURE_STEPS = 3
# the artifact's rungs, each served a labelled request of its size
COND_ARTIFACT_RUNGS = (1, 8, 64)
COND_DEMO_REQUESTS = 16
GEN_CLASS = 3
SAGAN128_STEPS = 3
DCGAN128_STEPS = 2


def cond_argv(workdir, name, preset, steps, argv):
    """train.cli.main's arguments for a run of this group called `name`."""
    tdir = os.path.join(workdir, name)
    return ["--preset", preset, "--max_steps", str(steps), "--batch_size",
            str(BATCH), "--device", "cuda", "--checkpoint_dir", tdir,
            "--sample_dir", os.path.join(tdir, "samples"), "--seed",
            str(SEED), "--sample_every_steps", "0",
            "--activation_summary_steps", "0"] + argv


def cond_cli(torch, np, name, argv, steps, per_step, kernels, path,
             group="conditional", unmoved=()):
    """train.cli.main on cuda, the launch counters set to 0 just before
    and read just after: each kernel exactly per_step[kernel] x steps
    launches; a finite loss row per step in events.jsonl; every parameter
    and BN statistic (and sn_* vector but those one element long, such
    as D's head's, which stay +-1) moved from the seeded init, but the
    "<params|bn>/<net>/<path>" leaves of `unmoved`, whose gradient may be
    0 in exact arithmetic. Adds the launches to launches_by_path; `group`
    names the phase in messages.
    Returns (final state, config, seconds, the loss rows per step)."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.steps import init_train_state

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    wrappers = all_wrappers()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    state = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for n, want in per_step.items():
        if launches[n] != want * steps:
            fail(f"{group} {name}: kernel {n} launched {launches[n]} "
                 f"times, expected {want} per step x {steps}")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})[path] = \
            launches[entry["name"]]
    with open(os.path.join(cfg.checkpoint_dir, "events.jsonl")) as f:
        rows = [json.loads(line)["values"] for line in f
                if json.loads(line)["kind"] == "scalars"]
    rows = [r for r in rows if "d_loss" in r]
    if len(rows) != steps or not all(
            np.isfinite([v for k, v in r.items() if not k.startswith(
                "perf/")]).all() for r in rows):
        fail(f"{group} {name}: {len(rows)} loss rows, or non-finite: "
             f"{rows}")
    init = init_train_state(cfg, device="cuda")
    still = [f"{part}/{net}/{p}" for part in ("params", "bn")
             for net in ("gen", "disc")
             for p, a in convert.flatten(init[part][net]).items()
             if not (p.startswith("sn_") and a.numel() == 1)
             and f"{part}/{net}/{p}" not in unmoved
             and torch.equal(a, convert.flatten(state[part][net])[p])]
    if still or int(state["step"]) != steps:
        fail(f"{group} {name}: leaves that did not move {still[:6]}, "
             f"step {int(state['step'])}")
    log(f"{group} {name}: {steps} steps of train.cli.main in "
        f"{secs:.1f} s, launches {launches}, every leaf moved, last losses "
        f"{ {k: round(v, 5) for k, v in rows[-1].items() if '/' not in k} }")
    return state, cfg, secs, rows


def cond_cifar_batches(np, root):
    """Fake CIFAR-10 python batches (the cifar-10-batches-py layout):
    COND_ROWS random uint8 rows and labels in each of data_batch_1..5."""
    import pickle

    rng = np.random.default_rng(SEED + 31)
    os.makedirs(root, exist_ok=True)
    for i in range(1, 6):
        with open(os.path.join(root, f"data_batch_{i}"), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (COND_ROWS, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, COND_ROWS).tolist()},
                        f)
    return root


def cond_check_serve_kernels(torch, mcfg, rungs, report,
                             tag="conditional"):
    """Kernels 2 and 5 against their plain versions at the shapes the
    sampler of `mcfg` (the conditional one; celeba64's in the evals group)
    gives them at each rung: kernel 2 at bn0 (relu), kernel 5 at each
    fused G stage, bf16, each launched twice and bit for bit, on the
    served designs. Called before the path's counts are set to 0."""
    from dcgan_tpu_torch.ops.fused import conv_patches, gbsa_plan, \
        gemm_bias_scale_act, gemm_bias_scale_act_plain, w_to_gemm
    from dcgan_tpu_torch.ops.kernels import sm_count

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 29)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    top = mcfg.gf_dim * 2 ** (mcfg.num_up_layers - 1)
    by_design = gemm_bias_scale_act.launches_by_design
    errs = {"scale_shift_act": 0.0, "gemm_bias_scale_act": 0.0}
    for b in rungs:
        x = rand(b * mcfg.base_size ** 2, top, lo=-2.0, hi=2.0).to(
            torch.bfloat16)
        errs["scale_shift_act"] = max(errs["scale_shift_act"], check_ssa_fwd(
            torch, f"{tag} bn0 b{b}", x, rand(top, lo=0.5, hi=1.5),
            rand(top, lo=-0.5, hi=0.5), ("relu",)))
        for name, m, k, c, res, in_ch in stage_shapes(mcfg, b):
            h = rand(b, res, res, in_ch, lo=0.0, hi=1.0).to(torch.bfloat16)
            p2d, _ = conv_patches(h, mcfg.kernel_size, 2, transpose=True)
            w2d = w_to_gemm(0.02 * torch.randn(
                (mcfg.kernel_size, mcfg.kernel_size, in_ch, c),
                generator=g, device=dev)).to(torch.bfloat16)
            bias, scale, shift = rand(c, lo=-0.1, hi=0.1), \
                rand(c, lo=0.5, hi=1.5), rand(c, lo=-0.5, hi=0.5)
            plan = gbsa_plan(m, k, c, torch.bfloat16, True, sm_count(dev))
            before = by_design[plan.design]
            got, again = (gemm_bias_scale_act(
                p2d, w2d, bias, scale, shift, "relu",
                out_dtype=torch.bfloat16) for _ in range(2))
            want = gemm_bias_scale_act_plain(p2d, w2d, bias, scale, shift,
                                             "relu", out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            if plan.design != GBSA_DESIGN or \
                    by_design[plan.design] != before + 2:
                fail(f"{tag}: gemm_bias_scale_act {name} b{b} plans "
                     f"{plan}")
            same_bits(torch, f"{tag} gemm_bias_scale_act {name} b{b}",
                      (got,), (again,))
            errs["gemm_bias_scale_act"] = max(
                errs["gemm_bias_scale_act"], check_close(
                    torch, f"{tag} gemm_bias_scale_act {name} b{b}",
                    got, want, "bfloat16"))
            log(f"{tag}: gemm_bias_scale_act {name} at rung b{b} "
                f"(M={m} K={k} C={c}) matches its plain version, repeats "
                f"bitwise; plan {plan._asdict()}")
    report["serve_kernel_checks"] = errs


def cond_served(torch, np, name, src, responses):
    """Each (z, labels or None, Response): finite float32 images of the
    model's shape within SERVED_TOL of a direct sampler call on its rows
    and labels (class 0 without). Returns the worst |err|."""
    from dcgan_tpu_torch.models.dcgan import sampler_apply

    mcfg = src.cfg
    worst = 0.0
    for z, labels, r in responses:
        img = r.result(timeout=60)
        n = z.shape[0]
        if img.shape != (n, mcfg.output_size, mcfg.output_size,
                         mcfg.c_dim) or img.dtype != np.float32 or \
                not np.isfinite(img).all():
            fail(f"conditional {name}: response {img.shape} {img.dtype}")
        lab = np.zeros(n, np.int32) if labels is None else labels
        want = sampler_apply(src._params, src._state,
                             torch.from_numpy(z).cuda(), cfg=mcfg,
                             labels=torch.from_numpy(lab).cuda())
        worst = max(worst, float(np.abs(want.float().cpu().numpy()
                                        - img).max()))
    if worst > SERVED_TOL:
        fail(f"conditional {name}: responses differ from direct sampler "
             f"calls by {worst} > {SERVED_TOL}")
    return worst


def cond_serve(torch, np, workdir, run, kernels, report):
    """The conditional checkpoint served: the serve entry point (demo
    requests, no labels: class 0), then a server on a CheckpointSource
    with labelled requests of every class, a request of mixed classes,
    requests without labels, and one z under two labels; generate
    --class_id; the launch counters set to 0 before the first and read
    after the last (the `cifar10_cond_serve` path: kernels 2 and 5)."""
    from dcgan_tpu_torch import generate
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve import __main__ as serve_main
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import CheckpointSource

    wrappers = all_wrappers()
    reset_counts(wrappers)
    row, demo = serve_main.run([
        "--checkpoint_dir", run, "--demo_requests", str(COND_DEMO_REQUESTS),
        "--demo_rps", "2000", "--max_batch", str(BATCH), "--max_wait_ms",
        "2", "--device", "cuda"])
    if row["completed"] != COND_DEMO_REQUESTS or row["serve/dropped"] or \
            row["serve/recompiles_after_warmup"]:
        fail(f"conditional serve entry point: {row}")
    src = CheckpointSource(run, device="cuda")
    server = SamplerServer(src, max_batch=BATCH, max_wait_ms=2.0)
    server.start()
    k = src.num_classes
    rng = np.random.default_rng(SEED + 37)

    def zs(n):
        return rng.uniform(-1.0, 1.0, (n, src.z_dim)).astype(np.float32)

    reqs = []
    for c in range(k):
        z = zs(1 + c % 5)
        lab = np.full(len(z), c, np.int32)
        reqs.append((z, lab, server.submit(z=z, labels=lab)))
    z = zs(2 * k)
    lab = (np.arange(2 * k) % k).astype(np.int32)
    reqs.append((z, lab, server.submit(z=z, labels=lab)))
    for n in (3, 5):
        z = zs(n)
        reqs.append((z, None, server.submit(z=z)))
    same = zs(4)
    pair = [(same, np.full(4, c, np.int32)) for c in (1, 7)]
    for z, lab in pair:
        reqs.append((z, lab, server.submit(z=z, labels=lab)))
    for _, _, r in reqs:
        r.result(timeout=60)
    server.stop()
    rep = server.report()
    if rep["serve/recompiles_after_warmup"] or rep["serve/dropped"]:
        fail(f"conditional server: {rep}")

    # generate --class_id on the same directory
    out = os.path.join(workdir, "cond_generated")
    npz = os.path.join(out, "gen.npz")
    gen = generate.main([
        "--checkpoint_dir", run, "--class_id", str(GEN_CLASS),
        "--num_images", str(GEN_IMAGES), "--batch_size", str(BATCH),
        "--grid", "0", "--npz", npz, "--out_dir", out, "--seed",
        str(GEN_SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["cifar10_cond_serve"] = \
            launches[entry["name"]]
    for n in ("scale_shift_act", "gemm_bias_scale_act"):
        if launches[n] < 1:
            fail(f"conditional serve: kernel {n} was not launched")
    for n in TRAIN_ONLY + tuple(FLASH_REPLACES):
        if launches[n]:
            fail(f"conditional serve: the sampler launched {n}")

    # the checks, after the path's counts are read
    worst = cond_served(torch, np, "labelled requests", src, reqs)
    moved = float(np.abs(reqs[-1][2].images - reqs[-2][2].images).max())
    if not moved > 0.0:
        fail("conditional: one z under classes 1 and 7 served the same "
             "images: the rung did not read its labels slot")
    # the entry point's demo requests: class 0, on the same weights
    demo_worst = cond_served(torch, np, "demo requests", src, [
        (np.random.default_rng((SEED, i)).uniform(
            -1.0, 1.0, (r.images.shape[0], src.z_dim)).astype(np.float32),
         None, r) for i, r in enumerate(demo[:4])])
    data = np.load(npz)
    images, labels = data["images"], data["labels"]
    if images.shape[0] != GEN_IMAGES or \
            not np.array_equal(labels, np.full(GEN_IMAGES, GEN_CLASS)):
        fail(f"generate --class_id: {images.shape}, labels "
             f"{np.unique(labels)}")
    lo = 0
    for i, n in enumerate(gen["buckets"]):
        z = torch.from_numpy(generate.generate_z(GEN_SEED, i, n,
                                                 src.z_dim)).cuda()
        want = sampler_apply(src._params, src._state, z, cfg=src.cfg,
                             labels=torch.full((n,), GEN_CLASS,
                                               dtype=torch.int32,
                                               device="cuda"))
        take = min(n, GEN_IMAGES - lo)
        if not np.array_equal(want.float().cpu().numpy()[:take],
                              images[lo:lo + take]):
            fail(f"generate --class_id batch {i} (rung {n}) differs from "
                 "the eager sampler on its z rows and class")
        lo += take
    report["serve"] = {"labelled_max_abs_err": worst,
                       "demo_max_abs_err": demo_worst,
                       "same_z_two_classes_moved": moved,
                       "p50_ms": rep["serve/p50_ms"],
                       "generate_buckets": gen["buckets"],
                       "launches": launches}
    log(f"conditional serve: {COND_DEMO_REQUESTS} demo requests through "
        f"the entry point (class 0) and {len(reqs)} labelled requests "
        f"(every class, mixed classes, none) within {worst:.3g} of direct "
        f"sampler calls; one z under classes 1 and 7 moved {moved:.4f}; "
        f"generate --class_id {GEN_CLASS} on rungs {gen['buckets']} equal "
        f"the eager sampler bit for bit; launches {launches}")
    src.close()


def cond_promote(torch, np, workdir, cfg, report):
    """A conditional-BN checkpoint (kernel 1's moments, plain epilogue)
    served, then promoted to a newer step: the ticket's captures 0, every
    served leaf at its address and the cBN tables now the new step's,
    the images a fresh source's on that step."""
    from dcgan_tpu_torch.config import save_config
    from dcgan_tpu_torch.convert import flatten
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import CheckpointSource
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    run = os.path.join(workdir, "cond_cbn_serve")
    cfg = dataclasses.replace(cfg, checkpoint_dir=run)
    save_config(cfg, run)
    fns = make_train_step(cfg)
    images, zs, draws = a1_inputs(torch, cfg, 1)
    (labels,) = cond_labels(torch, cfg, 1)
    s0 = fns.init(seed=SEED, device="cuda")
    s1, _ = fns.train_step(s0, images[0], zs[0], draws[0], labels)
    ckpt = Checkpointer(run)
    ckpt.save(0, s0)
    ckpt.wait()
    src = CheckpointSource(run, device="cuda")
    server = SamplerServer(src, max_batch=BATCH, max_wait_ms=1.0)
    server.start()
    z = np.random.default_rng(SEED + 41).uniform(
        -1.0, 1.0, (BATCH, cfg.model.z_dim)).astype(np.float32)
    lab = (np.arange(BATCH) % cfg.model.num_classes).astype(np.int32)
    before = server.submit(z=z, labels=lab).result(timeout=60)
    ptrs = {k: v.data_ptr() for k, v in flatten(src._params).items()}
    ckpt.save(1, s1)
    ckpt.wait()
    ticket = server.request_promote().result(timeout=60)
    after = server.submit(z=z, labels=lab).result(timeout=60)
    server.stop()
    if ticket.get("step") != 1 or ticket.get("compile_requests_delta"):
        fail(f"conditional cBN promotion: {ticket}")
    live = flatten(src._params)
    if {k: v.data_ptr() for k, v in live.items()} != ptrs:
        fail("conditional cBN promotion moved a served leaf")
    tables = [k for k in live if k.startswith("bn")]
    new = flatten(s1["params"]["gen"])
    stale = [k for k in tables if not torch.equal(live[k], new[k])]
    if not tables or stale or live["bn0/scale"].ndim != 2:
        fail(f"conditional cBN promotion: tables {tables}, not copied "
             f"{stale}")
    fresh = CheckpointSource(run, device="cuda")
    fresh.prepare()
    fresh.bind((BATCH,))
    want = fresh.sample(BATCH, z, lab)
    fresh.close()
    if not np.array_equal(after, want):
        fail("conditional cBN promotion: images after it differ from a "
             "fresh source on step 1")
    moved = float(np.abs(after - before).max())
    report["cbn_promotion"] = {"swap_ms": ticket["swap_ms"],
                               "tables": len(tables), "moved": moved}
    log(f"conditional cBN promotion: step 0 -> 1 in "
        f"{ticket['swap_ms']:.2f} ms, 0 captures, {len(tables)} cBN table "
        f"leaves copied into the served tensors at their addresses, the "
        f"images a fresh source's bit for bit (moved {moved:.4f})")


def cond_artifact(torch, np, workdir, run, report):
    """The conditional checkpoint exported on the card as call(z, labels)
    and served through ArtifactSource at COND_ARTIFACT_RUNGS, one labelled
    request per rung, within SERVED_TOL of the plain-route sampler."""
    from dcgan_tpu_torch.export import export_sampler
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import ArtifactSource, \
        CheckpointSource, StateSource

    art = os.path.join(workdir, "cond_sampler.pt2")
    side = export_sampler(run, art, device="cuda", max_serve_batch=BATCH)
    if side["num_classes"] != 10 or "labels" not in side["call"]:
        fail(f"conditional artifact sidecar: {side}")
    asrc = ArtifactSource(art, device="cuda")
    server = SamplerServer(asrc, buckets=COND_ARTIFACT_RUNGS,
                           max_batch=BATCH, max_wait_ms=0.0)
    server.start()
    ref = CheckpointSource(run, device="cuda")
    ref.prepare()
    plain = dataclasses.replace(ref.cfg, use_pallas=False,
                                pallas_fused=False)
    rng = np.random.default_rng(SEED + 43)
    errs = {}
    for b in COND_ARTIFACT_RUNGS:
        z = rng.uniform(-1.0, 1.0, (b, asrc.z_dim)).astype(np.float32)
        lab = (np.arange(b) % asrc.num_classes).astype(np.int32)
        got = server.submit(z=z, labels=lab).result(timeout=60)
        want = sampler_apply(ref._params, ref._state,
                             torch.from_numpy(z).cuda(), cfg=plain,
                             labels=torch.from_numpy(lab).cuda())
        errs[b] = float(np.abs(got - want.float().cpu().numpy()).max())
    rungs = asrc.compiled_buckets()   # stop() releases them
    server.stop()
    if rungs != COND_ARTIFACT_RUNGS or max(errs.values()) > SERVED_TOL:
        fail(f"conditional artifact: rungs {rungs}, |err| by rung {errs}")
    # the b64 rung on the kernel route, the cuDNN route and as the artifact
    top = COND_ARTIFACT_RUNGS[-1]
    timed = {}
    for name, src in (("kernel_route", ref), ("cudnn_route", StateSource(
            plain, ref._params, ref._state, device="cuda")), ("artifact",
                                                                asrc)):
        src.bind((top,))
        timed[name], _ = time_ms(torch, src._rungs[top][-1].run, 30,
                                 label=f"conditional {name} rung b{top}")
        src.close()
    report["artifact"] = {"bytes": side["bytes"], "max_abs_err": errs,
                          f"rung_ms_b{top}": timed}
    log(f"conditional artifact: call {side['call']}, {side['bytes']} bytes, "
        f"served at rungs {COND_ARTIFACT_RUNGS}: max |err| against the "
        f"plain-route sampler by rung {errs}; the captured b{top} rung, "
        f"ms: {timed}")


def cond_timed(torch, name, cfg, report, group="conditional"):
    """One captured step (K=1) timed on the host clock and profiled (busy
    ms, idle share); `group` names the phase in the log."""
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    fns = make_train_step(cfg)
    images, zs, draws = a1_inputs(torch, cfg, 2)
    labels = cond_labels(torch, cfg, 2)
    runner = StepRunner(fns, fns.init(seed=SEED, device="cuda"),
                        dataclasses.replace(cfg, steps_per_call=1),
                        torch.device("cuda"))
    runner.step(images[:1], zs[:1], draws[:1], start=0,
                labels=None if labels is None else labels[:1])

    def captured():
        runner.step(images[1:2], zs[1:2], draws[1:2], start=1,
                    labels=None if labels is None else labels[1:]).tolist()

    for _ in range(2):
        captured()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS // 4):
        captured()
    ms = (time.perf_counter() - t0) * 1e3 / (TIMED_STEPS // 4)
    split = profile_split(torch, captured, steps=PROFILED_CALLS, settle=True)
    out = {"step_ms": ms, "busy_ms": "not measured",
           "idle_share": "not measured",
           "pool_bytes": sum(p.pool_bytes for p in runner.programs.values())}
    if split is not None:
        out.update(busy_ms=split["busy_ms"], idle_share=split["idle_share"],
                   port_by_kernel=split["port_by_kernel"])
    report[name] = out
    log(f"{group} {name}: one captured step {ms:.3f} ms host-inclusive, "
        f"busy {out['busy_ms']} ms, idle share {out['idle_share']}, graph "
        f"pool {out['pool_bytes'] / 2 ** 30:.2f} GiB")
    runner.close()
    del runner
    torch.cuda.empty_cache()


def conditional_and_check(torch, np, workdir, kernels):
    """Phase 18: cifar10-cond from prepared shards on the kernel route,
    the routes and the conditional-BN step, serving, promotion, the
    artifact and generate; sagan128 and dcgan128. Returns the
    `conditional` report."""
    from dcgan_tpu_torch.data import prepare

    report = {}
    saved = torch.backends.cudnn.deterministic
    shards = os.path.join(workdir, "cifar10_shards")
    prepare.main(["--cifar10", "--input_dir", cond_cifar_batches(
        np, os.path.join(workdir, "cifar-10-batches-py")), "--output_dir",
        shards, "--num_shards", str(COND_SHARDS)])
    kernel_argv = ["--use_pallas", "--pallas_fused", "--data_dir", shards,
                   "--shuffle_buffer", str(2 * BATCH)]
    argv = cond_argv(workdir, "cifar10_cond", "cifar10-cond", COND_STEPS,
                     kernel_argv)
    a1_check_kernels(torch, workdir, "cifar10_cond", ["--preset",
                     "cifar10-cond"] + kernel_argv, BATCH, report)
    _, cfg, secs, _ = cond_cli(torch, np, "cifar10_cond", argv, COND_STEPS,
                            a1_per_step(1, 1, 2), kernels, "cifar10_cond")
    report["train_s"] = secs
    run = cfg.checkpoint_dir

    # the routes at one seeded state, and the conditional-BN step
    a1_route_grads(torch, "cifar10_cond", cfg, report)
    cond_timed(torch, "cifar10_cond_kernel_step", cfg, report)
    cond_timed(torch, "cifar10_cond_cudnn_step", dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, use_pallas=False,
                                       pallas_fused=False)), report)
    cbn = a1_config(workdir, "cond_cbn", ["--preset", "cifar10-cond",
                                          "--use_pallas", "--conditional_bn"])
    a1_route_grads(torch, "cond_cbn", cbn, report)
    a1_capture_compare(torch, "cond_cbn", cbn, COND_CAPTURE_STEPS)
    # the serving checks below compare captured rungs bit for bit
    torch.backends.cudnn.deterministic = True
    cond_promote(torch, np, workdir, cbn, report)

    # serving, generate and the artifact
    cond_check_serve_kernels(torch, cfg.model, COND_ARTIFACT_RUNGS, report)
    cond_serve(torch, np, workdir, run, kernels, report)
    cond_artifact(torch, np, workdir, run, report)
    torch.backends.cudnn.deterministic = saved

    # sagan128: attention at 64x64 (S 4096) on the flash kernels, which
    # phase 7 holds against their plain versions at that S
    _, s128, secs, _ = cond_cli(
        torch, np, "sagan128", cond_argv(workdir, "sagan128", "sagan128",
                                         SAGAN128_STEPS, ["--synthetic"]),
        SAGAN128_STEPS, SAGAN_PER_STEP, kernels, "sagan128")
    report["sagan128_train_s"] = secs
    cond_timed(torch, "sagan128_step", s128, report)
    # dcgan128 on its preset's route (cuDNN, torch BN): no port kernel
    _, _, secs, _ = cond_cli(
        torch, np, "dcgan128", cond_argv(workdir, "dcgan128", "dcgan128",
                                         DCGAN128_STEPS, ["--synthetic"]),
        DCGAN128_STEPS, {name: 0 for name in PER_STEP}, kernels, "dcgan128")
    report["dcgan128_train_s"] = secs
    return report


# ---------------------------------------------------------------------------
# evals: FID-50k of a celeba64 checkpoint, the trainer's probe (`evals`)
# ---------------------------------------------------------------------------

# the evals CLI's defaults: FID-50k at batch 256, KID over 100 subsets of
# 1000 from 10 000-feature reservoirs, PRDC at k 5 on the same reservoirs
EVAL_SAMPLES = 50_000
EVAL_BATCH = 256
EVAL_KID_POOL = 10_000
# the comparisons (the cuDNN route, another z seed, the cached real side)
# score this many samples a side, from a real side of their own: one
# FID-50k is the headline, and the route gap is mostly systematic (read
# at 50 000 and at 5 000 samples alike, see EVAL_ROUTE_FID_RTOL)
EVAL_COMPARE_SAMPLES = 5_000
# kernel launches of one celeba64 sampler call on the kernel route: kernel
# 2 at bn0, kernel 5 at each of the three interior stages
SAMPLER_PER_CALL = dict({name: 0 for name in PER_STEP}, scale_shift_act=1,
                        gemm_bias_scale_act=3)
# FID of the same weights and z on the kernel route against the cuDNN
# + torch-BN route, relative: the two routes' images differ only by where
# bf16 rounds (SERVED_TOL's rule). The cuDNN route rounds its BN math to
# bf16 op by op, the kernels once from f32, so the difference is partly
# systematic and does not average out over 50 000 samples: measured
# 1.887e-4 relative on the resume checkpoint (H100 at 700 W), 30 times the
# FID's move under another z seed (`seed_gap`, 6.4e-6), which is small
# here because this FID is mostly the distance between the two sides'
# means. At EVAL_COMPARE_SAMPLES the gap read 3.990e-5 to 3.109e-4 in
# five runs (z seed gaps 1.6-2.8e-5; H100 at 700 W): it moves more with
# 5 000 samples than with 50 000. The limit leaves 3.2 times the largest
# measured gap.
EVAL_ROUTE_FID_RTOL = 1e-3
# the tower's features on the card against the CPU on one batch, same
# weights, TF32 off on the card: f32 convolutions summed in another order
# (cuDNN's algorithm against the CPU's), |card - cpu| <= rtol * |cpu| +
# atol * max|cpu|
EVAL_TOWER_TOL = (1e-4, 1e-5)
# the probe: celeba64 on the kernel route for PROBE_STEPS steps from the
# resume group's records (native loader; the held-out stream reads the
# same shards), probing every PROBE_EVERY with PROBE_SAMPLES samples a
# side (the trainer's default), against the same run without the probe
PROBE_STEPS = 8
PROBE_EVERY = 4
PROBE_SAMPLES = 2048


def evals_cli(torch, argv, path, kernels, per_call, calls, overrides=None):
    """The evals CLI's `evaluate` on cuda, the launch counters set to 0
    just before and read just after: each kernel exactly per_call[kernel]
    x calls launches (the sampler's warm-up and its replays). Adds the
    launches to launches_by_path[path] when a path is named. Returns
    (result, timings)."""
    from dcgan_tpu_torch.evals import __main__ as evals_main

    args = evals_main.build_parser().parse_args(argv)
    wrappers = all_wrappers()
    reset_counts(wrappers)
    result, timings = evals_main.evaluate(args, model_overrides=overrides)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    want = {n: per_call.get(n, 0) * calls for n in wrappers}
    if launches != want:
        fail(f"evals {path or argv}: launches {launches}, expected {want}")
    if path is not None:
        for entry in kernels:
            entry.setdefault("launches_by_path", {})[path] = \
                launches[entry["name"]]
    fake_s = timings["sampler_s"] + timings["tower_s"] + timings["stats_s"]
    timings["samples_per_s"] = result["num_samples"] / fake_s
    log(f"evals {path or 'run'}: {json.dumps(result)}; seconds "
        f"{ {k: round(v, 3) for k, v in timings.items()} }; launches "
        f"{launches}")
    return result, timings


def eval_tower_check(torch, np, report):
    """The port's tower on the card against the CPU on one batch of
    synthetic reals, the same weights (drawn on the CPU from the seed)."""
    from dcgan_tpu_torch.data.synthetic import synthetic_batches
    from dcgan_tpu_torch.evals.features import make_random_feature_fn

    from dcgan_tpu_torch.evals import features

    x = next(synthetic_batches(EVAL_BATCH, 64, 3, seed=SEED + 1, pool=0))
    card, _ = make_random_feature_fn(64, 3, device="cuda")
    cpu, _ = make_random_feature_fn(64, 3, device="cpu")
    want = cpu(x)
    # TF32 on, as a process has it by default: the tower must turn it off
    # for its own calls; with that switch disabled, the error TF32 gives
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = card(torch.from_numpy(x).cuda()).cpu()
        keep, features.full_f32 = features.full_f32, \
            lambda device: contextlib.nullcontext()
        try:
            tf32 = card(torch.from_numpy(x).cuda()).cpu()
        finally:
            features.full_f32 = keep
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    rtol, atol = EVAL_TOWER_TOL
    err = (got - want).abs()
    scale = float(want.abs().max())
    limit = rtol * want.abs() + atol * scale
    worst = float((err / limit).max())
    report["tower_card_vs_cpu"] = {
        "max_abs_err": float(err.max()), "max_abs_feature": scale,
        "rtol": rtol, "atol_of_max": atol, "worst_of_limit": worst,
        "tf32_max_abs_err": float((tf32 - want).abs().max()),
        "tf32_worst_of_limit": float(((tf32 - want).abs() / limit).max())}
    log(f"evals: the tower's features on the card vs the CPU, batch "
        f"{EVAL_BATCH}: max |err| {float(err.max()):.3e} (max |feature| "
        f"{scale:.3e}), {worst:.3f} of the limit {EVAL_TOWER_TOL}; in "
        f"TF32 {report['tower_card_vs_cpu']['tf32_max_abs_err']:.3e}")
    if worst > 1.0:
        fail(f"evals: tower features on the card off the CPU's by "
             f"{worst:.2f} x the limit")


def probe_steps_ms(np, run):
    """Host ms per step from events.jsonl's stamps, leaving out the first
    two steps (the warm-up and the capture) and each step after a probe
    step (its interval holds the probe): the steps between probes."""
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    t = {e["step"]: e["time"] for e in events
         if e["kind"] == "scalars" and "d_loss" in e["values"]}
    gaps = [1e3 * (t[s] - t[s - 1]) for s in range(3, PROBE_STEPS + 1)
            if (s - 1) % PROBE_EVERY]
    return float(np.median(gaps)), gaps


def eval_probe(torch, np, workdir, kernels, report):
    """train.cli.main --fid_every_steps on the celeba64 kernel route, then
    the same run without the probe; the probe's scalars, best checkpoint
    and score.json; generate on the best directory."""
    from dcgan_tpu_torch import generate
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    data = os.path.join(workdir, "resume", "data")
    base = ["--preset", "celeba64", "--use_pallas", "--pallas_fused",
            "--data_dir", data, "--sample_image_dir", data,
            "--shuffle_buffer", str(RESUME_SHUFFLE), "--max_steps",
            str(PROBE_STEPS), "--batch_size", str(BATCH), "--seed",
            str(SEED), "--sample_every_steps", "0",
            "--activation_summary_steps", "0", "--device", "cuda"]
    runs = {}
    # the run without the probe first: neither run is the process's first
    for name, extra in (("no_probe", []),
                        ("probe", ["--fid_every_steps", str(PROBE_EVERY),
                                   "--fid_num_samples",
                                   str(PROBE_SAMPLES)])):
        run = os.path.join(workdir, "evals", name)
        argv = base + ["--checkpoint_dir", run, "--sample_dir",
                       os.path.join(run, "samples")] + extra
        wrappers = all_wrappers()
        reset_counts(wrappers)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(out.getvalue(), end="", flush=True)
        launches = {n: fn.launches for n, fn in wrappers.items()}
        probes = PROBE_STEPS // PROBE_EVERY if extra else 0
        # the probe's sampler: its warm-up, then one call per batch
        calls = 1 + probes * -(-PROBE_SAMPLES // BATCH) if probes else 0
        want = {n: PER_STEP[n] * PROBE_STEPS + SAMPLER_PER_CALL[n] * calls
                for n in wrappers}
        if launches != want:
            fail(f"evals {name}: launches {launches}, expected {want}")
        if extra:
            for entry in kernels:
                entry.setdefault("launches_by_path", {})["evals_probe"] = \
                    launches[entry["name"]]
        step_ms, gaps = probe_steps_ms(np, run)
        # the trainer's own seconds of each probe, from its [fid] lines
        runs[name] = {"run": run, "train_s": secs, "step_ms": step_ms,
                      "step_gaps_ms": gaps, "probe_s": [
                          float(t) for t in re.findall(
                              r"\[fid\] step \d+ .*, ([0-9.]+)s\)",
                              out.getvalue())]}
    run = runs["probe"]["run"]
    with open(os.path.join(run, "events.jsonl")) as f:
        fids = {e["step"]: e["values"] for e in map(json.loads, f)
                if e["kind"] == "scalars" and "eval/fid" in e["values"]}
    if sorted(fids) != [PROBE_EVERY * i for i in
                        range(1, PROBE_STEPS // PROBE_EVERY + 1)] or \
            not all(np.isfinite([v["eval/fid"], v["eval/kid"]]).all()
                    for v in fids.values()):
        fail(f"evals probe: eval scalars {fids}")
    best_dir = os.path.join(run, "best")
    with open(os.path.join(best_dir, "score.json")) as f:
        score = json.load(f)
    best_step = min(fids, key=lambda s: fids[s]["eval/fid"])
    if score != {"fid": fids[best_step]["eval/fid"], "step": best_step} \
            or Checkpointer(best_dir).latest_step() != best_step \
            or not os.path.exists(os.path.join(best_dir, "config.json")):
        fail(f"evals probe: best {score}, scalars {fids}, best dir "
             f"{sorted(os.listdir(best_dir))}")
    gen = generate.main(["--checkpoint_dir", best_dir, "--num_images", "8",
                         "--grid", "0", "--out_dir",
                         os.path.join(workdir, "evals", "best_gen"),
                         "--device", "cuda"])
    if gen["step"] != best_step:
        fail(f"evals probe: generate on best read step {gen['step']}")
    if len(runs["probe"]["probe_s"]) != len(fids):
        fail(f"evals probe: [fid] lines {runs['probe']['probe_s']}")
    report["probe"] = {
        "steps": PROBE_STEPS, "every": PROBE_EVERY,
        "samples": PROBE_SAMPLES, "scalars": fids, "best": score,
        "probe_s": runs["probe"]["probe_s"],
        "probe_train_s": runs["probe"]["train_s"],
        "no_probe_train_s": runs["no_probe"]["train_s"],
        "step_ms_between_probes": runs["probe"]["step_ms"],
        "step_ms_without_probe": runs["no_probe"]["step_ms"],
        "step_gaps_ms": {k: v["step_gaps_ms"] for k, v in runs.items()}}
    log(f"evals probe: {json.dumps(report['probe'])}")


def evals_and_check(torch, np, workdir, kernels):
    """Phase 19: the `resume` group's celeba64 checkpoint scored by the
    evals CLI at its defaults (50 000 samples, batch 256, KID pool
    10 000, --kid --prdc) on the kernel route, the headline; then at
    EVAL_COMPARE_SAMPLES a side: the kernel route (--kid --prdc)
    writing its own real side's statistics, the same weights and z on the
    cuDNN route and with another z seed (FID only), and the kernel route
    again from the cached real side (--kid --prdc), bit for bit; the tower on the card against the CPU;
    the trainer's probe. Returns the `evals` report."""
    from dcgan_tpu_torch.config import load_config

    report = {"samples": EVAL_SAMPLES, "batch": EVAL_BATCH,
              "kid_pool": EVAL_KID_POOL}
    root = os.path.join(workdir, "evals")
    run = os.path.join(root, "run")
    shutil.copytree(os.path.join(workdir, "resume", "run"), run,
                    ignore=shutil.ignore_patterns("*.corrupt*", "events*"))
    mcfg = load_config(run).model
    if not (mcfg.use_pallas and mcfg.pallas_fused):
        fail(f"evals: the resume checkpoint's route is {mcfg}")
    # the kernels at the eval sampler's batch, before the counted runs
    cond_check_serve_kernels(torch, mcfg, (EVAL_BATCH,), report,
                             tag="evals")
    saved = torch.backends.cudnn.deterministic
    # the cached rerun is compared bit for bit
    torch.backends.cudnn.deterministic = True
    stats = os.path.join(root, "real_stats.npz")
    # the CLI's defaults, spelled out
    argv = ["--checkpoint_dir", run, "--synthetic", "--real_stats", stats,
            "--num_samples", str(EVAL_SAMPLES), "--batch_size",
            str(EVAL_BATCH), "--kid_pool", str(EVAL_KID_POOL), "--device",
            "cuda"]
    full = ["--kid", "--prdc"]
    calls = 1 + -(-EVAL_SAMPLES // EVAL_BATCH)
    t0 = time.perf_counter()
    headline, h_t = evals_cli(torch, argv + full, "evals", kernels,
                              SAMPLER_PER_CALL, calls)
    report["headline"] = dict(headline, seconds=h_t)
    # the comparisons, from a real side of their own
    compare = ["--checkpoint_dir", run, "--synthetic", "--real_stats",
               os.path.join(root, "real_stats_compare.npz"),
               "--num_samples", str(EVAL_COMPARE_SAMPLES), "--batch_size",
               str(EVAL_BATCH), "--kid_pool", str(EVAL_KID_POOL),
               "--device", "cuda"]
    report["compare_samples"] = EVAL_COMPARE_SAMPLES
    calls = 1 + -(-EVAL_COMPARE_SAMPLES // EVAL_BATCH)
    # the kernel route and its cached rerun with --kid --prdc, so the
    # bit-for-bit check covers KID and PRDC on the cached real side too
    kernel, k_t = evals_cli(torch, compare + full, None, kernels,
                            SAMPLER_PER_CALL, calls)
    report["kernel"] = dict(kernel, seconds=k_t)
    plain, p_t = evals_cli(torch, compare, None, kernels, {}, 0,
                           dict(use_pallas=False, pallas_fused=False))
    seed1, s_t = evals_cli(torch, compare + ["--seed", "1"], None, kernels,
                           SAMPLER_PER_CALL, calls)
    cached, c_t = evals_cli(torch, compare + full, None, kernels,
                            SAMPLER_PER_CALL, calls)
    torch.backends.cudnn.deterministic = saved
    report["scoring_s"] = time.perf_counter() - t0
    gap = abs(kernel["fid"] - plain["fid"]) / plain["fid"]
    seed_gap = abs(kernel["fid"] - seed1["fid"]) / kernel["fid"]
    report["plain"] = dict(plain, seconds=p_t)
    report["seed1"] = dict(seed1, seconds=s_t)
    report["cached"] = dict(cached, seconds=c_t)
    report["route_fid_gap"] = gap
    report["route_fid_rtol"] = EVAL_ROUTE_FID_RTOL
    report["seed_gap"] = seed_gap
    log(f"evals: FID-50k {headline['fid']!r} in {h_t['total_s']:.1f} s; "
        f"at {EVAL_COMPARE_SAMPLES}: kernel route {kernel['fid']!r}, cuDNN "
        f"route "
        f"{plain['fid']!r} (gap {gap:.3e} relative, limit "
        f"{EVAL_ROUTE_FID_RTOL}), z seed 1 {seed1['fid']!r} (gap "
        f"{seed_gap:.3e}); cached real side {cached['fid']!r} in "
        f"{c_t['total_s']:.1f} s against {k_t['total_s']:.1f} s")
    if gap > EVAL_ROUTE_FID_RTOL:
        fail(f"evals: kernel-route FID {kernel['fid']} vs cuDNN route "
             f"{plain['fid']}: {gap:.3e} relative > {EVAL_ROUTE_FID_RTOL}")
    if cached != kernel or "kid" not in kernel or "precision" not in \
            kernel or c_t["real_s"] != 0.0 or k_t["real_s"] <= 0.0:
        fail(f"evals: the cached rerun {cached} differs from {kernel}, or "
             f"its real pass ran ({c_t['real_s']} s)")
    bad = [k for k, v in headline.items() if isinstance(v, float)
           and not np.isfinite(v)]
    if bad or headline["num_samples"] != EVAL_SAMPLES or \
            headline["feature_dim"] != 512 or "kid" not in headline:
        fail(f"evals: result {headline}")
    eval_tower_check(torch, np, report)
    eval_probe(torch, np, workdir, kernels, report)
    return report


# ---------------------------------------------------------------------------
# progressive: dcgan128 on a 32 -> 64 -> 128 ladder (`progressive`)
# ---------------------------------------------------------------------------

# the schedule: 4 steps at 32 px, 4 at 64, the rest of PROG_STEPS at 128,
# each later phase fading in over PROG_FADE steps
PROG_SPEC = "32:4,64:4,128:*"
PROG_PHASES = ((32, 0), (64, 4), (128, 8))   # resolution, first step
PROG_STEPS = 12
PROG_FADE = 2
# PNG images (PROG_SRC px a side) that `prepare` resizes into each
# resolution's shards, PROG_SHARDS shards each
PROG_IMAGES = 256
PROG_SRC = 96
PROG_SHARDS = 2
# the grid cadence of the main run: one grid in each phase
PROG_SAMPLE_EVERY = 4
# the checkpoint that generate opens (inside phase 1, r64) and the
# boundary checkpoint a resume starts from (phase 1's tree, r64)
PROG_GEN_AT = 6
PROG_RESUME_AT = 8
# the kernel-route sampler against the cuDNN + torch-BN route at a phase's
# state, max |difference| of the images (tanh range)
PROG_SAMPLER_TOL = 2e-2


class _Tee(io.TextIOBase):
    """Stdout that is also kept: the trainer's lines are checked."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def tee_stdout():
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee.kept


def prog_argv(root, name, argv):
    """train.cli.main's arguments for a progressive run called `name` on
    the {res} shards under `root`."""
    tdir = os.path.join(root, name)
    return ["--preset", "dcgan128", "--use_pallas", "--pallas_fused",
            "--progressive", PROG_SPEC, "--progressive_fade_steps",
            str(PROG_FADE), "--max_steps", str(PROG_STEPS), "--batch_size",
            str(BATCH), "--data_dir", os.path.join(root, "train_{res}"),
            "--sample_image_dir", os.path.join(root, "no_held_out"),
            "--shuffle_buffer", str(2 * BATCH), "--checkpoint_dir", tdir,
            "--sample_dir", os.path.join(tdir, "samples"), "--seed",
            str(SEED), "--activation_summary_steps", "0", "--device",
            "cuda"] + argv


def prog_shards(np, root):
    """PROG_IMAGES random PNGs, then `prepare` shards of them at each
    phase's resolution under root/train_<res>."""
    from PIL import Image

    from dcgan_tpu_torch.data import prepare

    src = os.path.join(root, "photos")
    os.makedirs(src)
    rng = np.random.default_rng(SEED + 41)
    for i in range(PROG_IMAGES):
        Image.fromarray(rng.integers(0, 256, (PROG_SRC, PROG_SRC, 3),
                                     dtype=np.uint8)).save(
            os.path.join(src, f"img{i:04d}.png"))
    for res, _ in PROG_PHASES:
        prepare.main(["--input_dir", src, "--output_dir",
                      os.path.join(root, f"train_{res}"), "--image_size",
                      str(res), "--crop_size", "0", "--num_shards",
                      str(PROG_SHARDS)])


def prog_expected(counts):
    """The kernel launches of the main run: per phase (stages, training
    steps including a primed runner's warm-up step, sampler calls), each
    training step a1_per_step(1, 1, stages), each sampler call kernel 2
    at bn0 and kernel 5 at each stage."""
    total = {name: 0 for name in PER_STEP}
    for stages, steps, calls in counts:
        for name, n in a1_per_step(1, 1, stages).items():
            total[name] += n * steps
        total["scale_shift_act"] += calls
        total["gemm_bias_scale_act"] += calls * stages
    return total


def prog_main_run(torch, np, root, kernels, report):
    """The main run: train.cli.main over the whole ladder with
    --aot_warmup and a grid in each phase, the launch counters set to 0
    just before and read just after (the `progressive` path), every
    capture recorded: only the warm-up plan's rows are captured, both
    switch lines report the CPU carry count and captures_during_switch=0;
    per-phase median step ms, switch ms and graph pools."""
    from dcgan_tpu_torch import graphs
    from dcgan_tpu_torch.progressive import carry_state
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.steps import init_train_state

    argv = prog_argv(root, "run", [
        "--aot_warmup", "--sample_every_steps", str(PROG_SAMPLE_EVERY)])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    captures = []
    real_capture = graphs.CapturedProgram.capture

    def recording(program):
        ms = real_capture(program)
        captures.append((program.name, program.pool_bytes))
        return ms

    wrappers = all_wrappers()
    reset_counts(wrappers)
    torch.cuda.reset_peak_memory_stats()
    graphs.CapturedProgram.capture = recording
    t0 = time.perf_counter()
    try:
        with tee_stdout() as out:
            state = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        graphs.CapturedProgram.capture = real_capture
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["progressive"] = \
            launches[entry["name"]]
    # stages per phase: num_up_layers - 1 (2, 3, 4); the later phases'
    # runners each took one warm-up step on zeros; each phase's sampler
    # ran its warm-up and one grid
    steps_in = [PROG_PHASES[1][1], PROG_PHASES[2][1] - PROG_PHASES[1][1],
                PROG_STEPS - PROG_PHASES[2][1]]
    want = prog_expected([(2, steps_in[0], 2), (3, steps_in[1] + 1, 2),
                          (4, steps_in[2] + 1, 2)])
    if launches != want:
        fail(f"progressive: launches {launches}, expected {want}")
    for n, design in TRAIN_DESIGN.items():
        by = wrappers[n].launches_by_design
        if by[design] != launches[n]:
            fail(f"progressive: {n} launches must all take design "
                 f"{design}: {by}")
    if int(state["step"]) != PROG_STEPS:
        fail(f"progressive: the run ended at step {int(state['step'])}")
    events = read_jsonl(os.path.join(cfg.checkpoint_dir, "events.jsonl"))
    rows = [(e["step"], e["values"]) for e in events
            if e["kind"] == "scalars"]
    compile_ms = {k.split("/", 2)[2]: v for _, r in rows
                  for k, v in r.items() if k.startswith("perf/compile_ms/")}
    plan = ["train_step", "sampler", "train_step@r64", "sampler@r64",
            "train_step@r128", "sampler@r128"]
    if list(compile_ms) != plan or len(captures) != len(plan):
        fail(f"progressive: the plan captured {list(compile_ms)}, the run "
             f"{[n for n, _ in captures]} (expected {plan}, nothing after "
             "the warm-up)")
    pools = {}
    for name, (_, pool) in zip(plan, captures):
        res = name.split("@r")[1] if "@r" in name else "32"
        pools[f"r{res}"] = pools.get(f"r{res}", 0) + pool
    loss_rows = [r for _, r in rows if "d_loss" in r]
    if len(loss_rows) != PROG_STEPS or not all(
            np.isfinite([r[k] for k in ("d_loss", "g_loss")]).all()
            for r in loss_rows):
        fail(f"progressive: {len(loss_rows)} loss rows, or non-finite")
    res_seen = [int(r["progressive/resolution"]) for r in loss_rows]
    want_res = [res for (res, _), n in zip(PROG_PHASES, steps_in)
                for _ in range(n)]
    if res_seen != want_res:
        fail(f"progressive: rows at resolutions {res_seen}, expected "
             f"{want_res}")
    alphas = [r.get("progressive/alpha") for r in loss_rows]
    switch_ms = [r["progressive/switch_ms"] for _, r in rows
                 if "progressive/switch_ms" in r]
    lines = [ln for ln in out.getvalue().splitlines()
             if "] progressive phase" in ln]
    if len(lines) != 2 or len(switch_ms) != 2:
        fail(f"progressive: switch lines {lines}, rows {switch_ms}")
    for line, (old, new) in zip(lines, ((PROG_PHASES[0], PROG_PHASES[1]),
                                        (PROG_PHASES[1], PROG_PHASES[2]))):
        _, carried = carry_state(*(init_train_state(dataclasses.replace(
            cfg, progressive="", progressive_fade_steps=0,
            model=dataclasses.replace(cfg.model, output_size=res)),
            device="cpu") for res in (old[0], new[0])), arch="dcgan",
            shift=1)
        want_line = (f"at step {new[1]}: r{old[0]} -> r{new[0]} (batch "
                     f"{BATCH}, {carried} leaves carried)")
        if want_line not in line or \
                not line.endswith("captures_during_switch=0"):
            fail(f"progressive: switch line {line!r}, expected "
                 f"{want_line!r} ... captures_during_switch=0")
    # one grid in each phase, at the phase's resolution
    for (res, _), step in zip(PROG_PHASES, range(
            PROG_SAMPLE_EVERY, PROG_STEPS + 1, PROG_SAMPLE_EVERY)):
        with open(os.path.join(cfg.sample_dir,
                               f"train_{step:08d}.png"), "rb") as f:
            shape = decode_png(np, f.read()).shape
        if shape != (8 * res, 8 * res, 3):
            fail(f"progressive: the grid of step {step} decodes to {shape}")
    # the median step of each phase: the p50 of its StepTimer (fresh at
    # each switch) at the phase's last step, over its replayed steps
    p50 = {}
    for (res, start), n in zip(PROG_PHASES, steps_in):
        last = [r for s, r in rows if s == start + n and "d_loss" in r][0]
        p50[f"r{res}"] = last.get("perf/step_ms_p50", "not measured")
    report["main"] = {
        "seconds": secs, "launches": launches, "compile_ms": compile_ms,
        "pool_bytes": pools, "peak_reserved": peak,
        "step_ms_p50": p50, "switch_ms": switch_ms, "alphas": alphas,
        "switch_lines": lines}
    log(f"progressive: {PROG_STEPS} steps of {PROG_SPEC!r} on the kernel "
        f"route in {secs:.1f} s, launches {launches}; captured only the "
        f"plan's {len(plan)} rows (ms {compile_ms}); graph pools by phase "
        f"{pools}; peak reserved {peak / 2 ** 30:.2f} GiB of the card's "
        f"80 GB; median step ms {p50}; switch ms {switch_ms}; "
        + " | ".join(lines))
    return cfg


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def prog_switch_checks(torch, cfg, report):
    """The trainer's switch, step by step, on the card: a phase's runner
    (steps replayed), the next phase's runner built and primed on zeros
    with its train row captured, `advance` onto it and `load`: every
    carried leaf equal bit for bit to its value read before the switch,
    the count carry_state's on the CPU for the same trees; at the merged
    state the first step's losses and gradients, kernel route against the
    cuDNN route (a1_route_grads: TRAIN_ROUTE_TOL, TRAIN_GRAD_TOL); at each
    phase's state the captured kernel-route sampler against the cuDNN
    route's within PROG_SAMPLER_TOL."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.progressive import PhaseRuntime, carry_path, \
        carry_state, parse_schedule
    from dcgan_tpu_torch.progressive.phases import PHASE_SEED_OFFSET
    from dcgan_tpu_torch.train.steps import init_train_state, \
        make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    dev = torch.device("cuda")
    rt = PhaseRuntime(cfg, parse_schedule(
        cfg.progressive, model=cfg.model, batch_size=cfg.batch_size,
        max_steps=cfg.max_steps, fade_steps=cfg.progressive_fade_steps),
        PROG_STEPS)
    sample_z = torch.rand((BATCH, cfg.model.z_dim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED + 1)) * 2 - 1

    def runner_of(i, state):
        cfg_i, fns_i = rt.surface(i)
        r = StepRunner(fns_i, state, cfg_i, dev, sample_z=sample_z)
        r.prime(start=rt.starts[i])
        r.capture("train_step")
        r.capture("sampler")
        return r

    runner = runner_of(0, rt.fns.init(seed=SEED, device=dev))
    gaps = {}
    for i, (res, start) in enumerate(PROG_PHASES):
        cfg_i, fns_i = rt.surface(i)
        if i:
            nxt = runner_of(i, fns_i.init(
                seed=SEED + PHASE_SEED_OFFSET + i, device=dev))
            before = {p: t.clone() for p, t in
                      convert.flatten(runner.state).items()}
            merged = rt.advance(runner.state)
            nxt.load(merged)
            del merged
            runner.close()
            runner = nxt
            _, cpu = carry_state(
                init_train_state(rt.surface(i - 1)[0], device="cpu"),
                init_train_state(cfg_i, device="cpu"), arch="dcgan",
                shift=1)
            now = convert.flatten(runner.state)
            same = 0
            for path, t in before.items():
                home = carry_path(path, arch="dcgan", shift=1)
                if home in now and now[home].shape == t.shape \
                        and now[home].dtype == t.dtype:
                    if not torch.equal(now[home], t):
                        fail(f"progressive r{res}: carried leaf {home} "
                             f"differs from {path} before the switch")
                    same += 1
            if not same == rt.last_carried == cpu:
                fail(f"progressive r{res}: {same} leaves carried bit for "
                     f"bit, advance counted {rt.last_carried}, the CPU "
                     f"trees {cpu}")
            del before, now
            a1_route_grads(torch, f"progressive_r{res}", cfg_i,
                           report, state=runner.state)
            log(f"progressive r{res}: {cpu} leaves carried bit for bit "
                f"into the primed runner (advance in "
                f"{rt.last_switch_ms:.1f} ms); the first step's losses and "
                "gradients within the route tolerances")
        images, zs, draws = a1_inputs(torch, cfg_i, 2)
        for j in range(2):
            runner.step(images[j:j + 1], zs[j:j + 1], draws[j:j + 1],
                        start=start + j)
        got = runner.sample().float()
        plain = make_train_step(dataclasses.replace(
            cfg_i, model=dataclasses.replace(
                cfg_i.model, use_pallas=False, pallas_fused=False)))
        want = plain.sample(runner.state, sample_z).float()
        gap = float((got - want).abs().max())
        gaps[f"r{res}"] = gap
        if not (gap <= PROG_SAMPLER_TOL and bool(torch.isfinite(got).all())
                and got.shape == (BATCH, res, res, 3)):
            fail(f"progressive r{res}: the kernel-route sampler is "
                 f"{gap:.3g} off the cuDNN route (limit "
                 f"{PROG_SAMPLER_TOL}), shape {tuple(got.shape)}")
    runner.close()
    report["sampler_route_gap"] = gaps
    log(f"progressive: the captured kernel-route sampler against the cuDNN "
        f"route at each phase's state, max |difference| {gaps} (limit "
        f"{PROG_SAMPLER_TOL})")


def prog_resume_and_generate(torch, np, root, report):
    """A run saving every step to PROG_RESUME_AT, then: generate on the
    step-PROG_GEN_AT checkpoint alone builds the 64 px model with no
    flags; a resume from the step-PROG_RESUME_AT checkpoint (tagged
    phase 1, r64) starts in phase 1 and switches to r128 at once."""
    from dcgan_tpu_torch import generate
    from dcgan_tpu_torch.train import cli, trainer
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    argv = prog_argv(root, "resume", ["--save_model_secs", "0",
                                      "--max_checkpoints", "3",
                                      "--sample_every_steps", "0"])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    trainer.train(cfg, max_steps=PROG_RESUME_AT, device="cuda")
    ckpt = Checkpointer(cfg.checkpoint_dir)
    tags = {s: ckpt.progressive_tag_of(s)
            for s in (PROG_GEN_AT, PROG_RESUME_AT)}
    if any(t != {"phase": 1, "resolution": 64} for t in tags.values()):
        fail(f"progressive: checkpoint tags {tags}")
    # the step-6 checkpoint alone, as a run stopped there leaves it
    gen_dir = os.path.join(root, "gen_run")
    os.makedirs(os.path.join(gen_dir, "integrity"))
    shutil.copy(os.path.join(cfg.checkpoint_dir, "config.json"), gen_dir)
    shutil.copytree(os.path.join(cfg.checkpoint_dir, str(PROG_GEN_AT)),
                    os.path.join(gen_dir, str(PROG_GEN_AT)))
    shutil.copy(os.path.join(cfg.checkpoint_dir, "integrity",
                             f"{PROG_GEN_AT}.json"),
                os.path.join(gen_dir, "integrity"))
    npz = os.path.join(root, "gen.npz")
    result = generate.main(["--checkpoint_dir", gen_dir, "--num_images",
                            "16", "--batch_size", "16", "--grid", "0",
                            "--npz", npz, "--out_dir",
                            os.path.join(root, "generated"), "--device",
                            "cuda"])
    images = np.load(npz)["images"]
    if result["step"] != PROG_GEN_AT or images.shape != (16, 64, 64, 3) \
            or not np.isfinite(images).all():
        fail(f"progressive: generate on step {PROG_GEN_AT} gave step "
             f"{result['step']}, images {images.shape}")
    with tee_stdout() as out:
        state = trainer.train(cfg, max_steps=PROG_RESUME_AT + 2,
                              device="cuda")
    text = out.getvalue()
    for want in ("starting in phase 1 (r64", f"progressive phase 2 at step "
                 f"{PROG_RESUME_AT}: r64 -> r128"):
        if want not in text:
            fail(f"progressive: the resume printed no {want!r}")
    if int(state["step"]) != PROG_RESUME_AT + 2 or \
            ckpt.progressive_tag_of(PROG_RESUME_AT + 2) != \
            {"phase": 2, "resolution": 128}:
        fail("progressive: the resume's final checkpoint is not phase 2's")
    report["resume"] = {"tags": {str(k): v for k, v in tags.items()},
                        "generate_images": list(images.shape)}
    log(f"progressive: checkpoints {PROG_GEN_AT} and {PROG_RESUME_AT} "
        f"tagged {tags}; generate on step {PROG_GEN_AT} alone built the "
        f"64 px model with no flags ({list(images.shape)}); the resume from "
        f"step {PROG_RESUME_AT} started in phase 1 and switched r64 -> r128")


def progressive_and_check(torch, np, workdir, kernels):
    """Phase 20: dcgan128 (gf = df = 64, batch 64, bf16) on the kernel
    route over the 32 -> 64 -> 128 ladder from `prepare` shards: kernels
    1-4 and 2, 5 against their plain versions at every phase's shapes,
    the main run, the switch step by step, the resume and generate.
    Returns the `progressive` report."""
    from dcgan_tpu_torch.train import cli

    report = {"spec": PROG_SPEC, "steps": PROG_STEPS}
    root = os.path.join(workdir, "progressive")
    os.makedirs(root)
    t0 = time.perf_counter()
    prog_shards(np, root)
    report["prepare_s"] = time.perf_counter() - t0
    for res, _ in PROG_PHASES:
        argv = ["--preset", "dcgan128", "--use_pallas", "--pallas_fused",
                "--output_size", str(res)]
        sub = report.setdefault(f"r{res}", {})
        a1_check_kernels(torch, workdir, f"progressive_r{res}", argv, BATCH,
                         sub)
        cond_check_serve_kernels(torch, cli.config_from_args(
            cli.build_parser().parse_args(argv)).model, (BATCH,), sub,
            tag=f"progressive r{res}")
    cfg = prog_main_run(torch, np, root, kernels, report)
    prog_switch_checks(torch, cfg, report)
    prog_resume_and_generate(torch, np, root, report)
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# the resnet and stylegan model families (`families`)
# ---------------------------------------------------------------------------

# sngan-cifar10's train.cli.main runs on the kernel route (each step five
# critic updates), the WGAN-GP and the attention runs beside it, and the
# eager / captured comparison
FAM_STEPS = 3
FAM_WGAN_STEPS = 2
FAM_ATTN_STEPS = 2
FAM_ATTN_RES = 16
FAM_COMPARE_STEPS = 2
# stylegan64: lazy R1 every 16th step, so 17 steps meet it twice (0, 16)
STYLEGAN_STEPS = 17
# the served rungs of both families, and the evals CLI's sample count
FAM_RUNGS = (1, 8, 64)
FAM_DEMO_REQUESTS = 16
FAM_EVAL_SAMPLES = 1024
# the critic's output bias: its gradient is the real batch's mean loss
# slope plus the fake batch's, which cancel exactly under WGAN's loss (the
# penalty does not see the bias), under the hinge loss while every logit
# is inside the margin, and under BCE to the bit while the logits are
# near 0 (sigmoid(x) - 1 and sigmoid(x') sum to 0 in the compute dtype)
HEAD_BIAS = ("params/disc/head/b",)


def resnet_bn_shapes(mcfg, batch):
    """(name, rows, channels) of every BatchNorm of the resnet generator
    at `batch` images: b{i}_bn1 on block i's input, b{i}_bn2 after its
    upsampled conv1, bn_out on the last map (2k + 1 in all)."""
    from dcgan_tpu_torch.models.resnet import _g_channels

    chans = _g_channels(mcfg)
    k, base = mcfg.num_up_layers, mcfg.base_size
    out = []
    for i in range(1, k + 1):
        res = base * 2 ** (i - 1)
        out += [(f"b{i}_bn1", batch * res * res, chans[i - 1]),
                (f"b{i}_bn2", batch * 4 * res * res, chans[i])]
    return out + [("bn_out", batch * (base * 2 ** k) ** 2, chans[k])]


def fam_per_step(n_critic, bns, attn=False):
    """Kernel launches per training step of the resnet family, derived
    from the step: each critic update runs G forward without gradients
    (bns BatchNorms: one channel_moments and one scale_shift_act each; D
    is norm-free, and a penalty's critic sees G's images detached), G's
    update runs G forward with gradients (bns and bns) and back (one
    scale_shift_act_bwd each). With the attention block in both nets on
    the flash kernels: per critic update G once and D on the real and the
    fake batch forward (3 flash_fwd), D back through both (2 flash_dq, 2
    flash_dkv); G's update G and D forward (2) and back (2, 2)."""
    n = n_critic
    per = dict({name: 0 for name in PER_STEP},
               channel_moments=(n + 1) * bns, scale_shift_act=(n + 1) * bns,
               scale_shift_act_bwd=bns)
    if attn:
        per.update(flash_fwd=3 * n + 2, flash_dq=2 * n + 2,
                   flash_dkv=2 * n + 2)
    return per


def fam_check_kernels(torch, mcfg, batch, report):
    """Kernels 1-3 against their plain versions at every BatchNorm shape
    of the resnet generator of `mcfg` at `batch` images, bf16 and f32,
    each launched twice and bit for bit, the design of each logged (and
    checked where the plan names it). Called before the path's counts are
    set to 0."""
    from dcgan_tpu_torch.ops.kernels import scale_shift_act, \
        scale_shift_act_plain, ssa_bwd_design, ssa_fwd_design

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 47)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    errs = {}
    designs = scale_shift_act.launches_by_design
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        e = errs[dt_name] = dict.fromkeys(
            ("channel_moments", "scale_shift_act", "scale_shift_act_bwd"),
            0.0)
        for name, n, c in resnet_bn_shapes(mcfg, batch):
            tag = f"families {name} [{n}, {c}] {dt_name}"
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            err, plan = check_moments(torch, tag, x)
            e["channel_moments"] = max(e["channel_moments"], err)
            scale, shift = rand(c, lo=0.5, hi=1.5), rand(c, lo=-0.5, hi=0.5)
            bwd = ssa_bwd_design(c, dt, True)
            e["scale_shift_act_bwd"] = max(
                e["scale_shift_act_bwd"], check_ssa_bwd(
                    torch, tag, x, rand(n, c).to(dt), scale, shift, "relu",
                    bwd))
            fwd = ssa_fwd_design(c, dt, True)
            before = dict(designs)
            y, again = (scale_shift_act(x, scale, shift, "relu")
                        for _ in range(2))
            torch.cuda.synchronize()
            if designs != dict(before, **{fwd: before[fwd] + 2}):
                fail(f"scale_shift_act {tag} did not take design {fwd}: "
                     f"{before} -> {designs}")
            same_bits(torch, f"scale_shift_act {tag}", (y,), (again,))
            e["scale_shift_act"] = max(e["scale_shift_act"], check_close(
                torch, f"scale_shift_act {tag}", y,
                scale_shift_act_plain(x, scale, shift, "relu"), dt_name))
            log(f"{tag}: channel_moments plan {plan._asdict()}, "
                f"scale_shift_act design {fwd}, its backward design {bwd}; "
                "each matches its plain version and repeats bitwise")
    report["kernel_checks"] = errs


def fam_attention(torch, np, workdir, data, per_step, kernels, report):
    """sngan-cifar10 with the attention block at FAM_ATTN_RES in both nets
    on the flash kernels (and G's BatchNorm on kernels 1-3): the trainer
    at exactly `per_step` launches (the `resnet_attention` path); then
    from the seeded state with gamma 0.5 in both blocks, BatchNorm on
    plain ops so that only the attention differs, the losses and every
    gradient leaf on the flash route against the dense route within
    ATTN_ROUTE_TOL and ATTN_GRAD_TOL, bf16 and f32."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.train.steps import make_train_step

    argv = cond_argv(workdir, "resnet_attention", "sngan-cifar10",
                     FAM_ATTN_STEPS, ["--use_pallas", "--attn_res",
                                      str(FAM_ATTN_RES)] + data)
    _, cfg, secs, _ = cond_cli(
        torch, np, "resnet_attention", argv, FAM_ATTN_STEPS, per_step,
        kernels, "resnet_attention", group="families", unmoved=HEAD_BIAS)
    out = report["attention"] = {"train_s": secs}
    images, zs, draws = a1_inputs(torch, cfg, 1)
    for dt_name in ("bfloat16", "float32"):
        losses, grads = {}, {}
        for route, use_pallas in (("flash", True), ("dense", False)):
            rcfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, compute_dtype=dt_name, use_pallas=use_pallas,
                bn_pallas=False if use_pallas else None))
            fns = make_train_step(rcfg)
            state = fns.init(seed=SEED, device="cuda")
            for net in ("gen", "disc"):
                state["params"][net]["attn"]["gamma"].fill_(0.5)
            grads[route], metrics = fns.grads(state, images[0], zs[0],
                                              draws[0])
            losses[route] = {k: float(v) for k, v in metrics.items()}
        rtol, atol = ATTN_ROUTE_TOL[dt_name]
        bad = [k for k in losses["flash"] if not abs(
            losses["flash"][k] - losses["dense"][k])
            <= rtol * abs(losses["dense"][k]) + atol]
        if bad:
            fail(f"families attention losses ({dt_name}), flash vs dense: "
                 f"{losses}, outside rtol={rtol} atol={atol}: {bad}")
        rtol, atol = ATTN_GRAD_TOL[dt_name]
        gaps = grad_gaps(convert, grads["flash"], grads["dense"], rtol, atol)
        worst = max(gaps, key=gaps.get)
        out[dt_name] = {"losses": losses, "worst_grad_gap":
                        [worst, gaps[worst]],
                        "attn_grad_gaps": {k: v for k, v in gaps.items()
                                           if "/attn/" in k}}
        if gaps[worst] > 1.0:
            fail(f"families attention gradients ({dt_name}), flash vs "
                 f"dense, outside rtol={rtol} atol={atol}: "
                 f"{ {k: v for k, v in gaps.items() if v > 1.0} }")
        log(f"families attention ({dt_name}): the flash route matches the "
            f"dense route, losses {losses['flash']} vs {losses['dense']}, "
            f"{len(gaps)} gradient leaves, the closest {worst} at "
            f"{gaps[worst]:.3g} of its limit")


def fam_serve(torch, np, workdir, name, run, kernels, report, per_replay):
    """A family's checkpoint served and exported: the serve entry point
    (demo requests) on captured rungs, recompiles_after_warmup 0; a
    CheckpointSource bound at FAM_RUNGS, each rung's capture holding
    `per_replay` launches of each kernel (kernel 2 at every BatchNorm of
    the resnet sampler, none of stylegan's) and its images a direct
    sampler call's within SERVED_TOL; generate equal to the eager sampler
    on its z rows bit for bit; the export served through ArtifactSource at
    FAM_RUNGS within SERVED_TOL of the plain-route sampler; the evals CLI
    at FAM_EVAL_SAMPLES samples. The counters are set to 0 before the
    first and read after the last serving call (the `<name>_serve`
    path)."""
    from dcgan_tpu_torch import generate
    from dcgan_tpu_torch.export import export_sampler
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.serve import __main__ as serve_main
    from dcgan_tpu_torch.serve.server import SamplerServer
    from dcgan_tpu_torch.serve.sources import ArtifactSource, \
        CheckpointSource

    wrappers = all_wrappers()
    reset_counts(wrappers)
    row, demo = serve_main.run([
        "--checkpoint_dir", run, "--demo_requests", str(FAM_DEMO_REQUESTS),
        "--demo_rps", "2000", "--max_batch", str(BATCH), "--max_wait_ms",
        "2", "--device", "cuda"])
    if row["completed"] != FAM_DEMO_REQUESTS or row["serve/dropped"] or \
            row["serve/recompiles_after_warmup"]:
        fail(f"families {name} serve entry point: {row}")
    src = CheckpointSource(run, device="cuda")
    server = SamplerServer(src, buckets=FAM_RUNGS, max_batch=BATCH,
                           max_wait_ms=0.0)
    server.start()
    rng = np.random.default_rng(SEED + 53)
    reqs = []
    for b in FAM_RUNGS:
        z = rng.uniform(-1.0, 1.0, (b, src.z_dim)).astype(np.float32)
        reqs.append((z, server.submit(z=z)))
    for _, r in reqs:
        r.result(timeout=60)
    # a capture's launches (none where the rungs run eagerly: the CPU)
    per_rung = {b: {n: (prog.launches or {}).get(n, (0,))[0]
                    for n in wrappers}
                for b, (_, _, prog) in src._rungs.items()}
    server.stop()
    rep = server.report()
    out = os.path.join(workdir, f"{name}_generated")
    npz = os.path.join(out, "gen.npz")
    gen = generate.main([
        "--checkpoint_dir", run, "--num_images", str(GEN_IMAGES),
        "--batch_size", str(BATCH), "--grid", "0", "--npz", npz,
        "--out_dir", out, "--seed", str(GEN_SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})[f"{name}_serve"] = \
            launches[entry["name"]]
    if rep["serve/recompiles_after_warmup"] or rep["serve/dropped"]:
        fail(f"families {name} server: {rep}")
    want_rung = {n: per_replay.get(n, 0) for n in wrappers}
    bad = {b: c for b, c in per_rung.items() if c != want_rung}
    if sorted(per_rung) != sorted(FAM_RUNGS) or bad:
        fail(f"families {name}: rung launches {bad or per_rung}, expected "
             f"{want_rung} on each of {FAM_RUNGS}")
    if per_replay and not all(launches[n] > 0 for n in per_replay):
        fail(f"families {name} serve: launches {launches}")
    if not per_replay and any(launches.values()):
        fail(f"families {name} serve launched a port kernel: {launches}")

    # the checks, after the path's counts are read
    worst = 0.0
    for z, r in reqs:
        img = r.result(timeout=60)
        want = sampler_apply(src._params, src._state,
                             torch.from_numpy(z).cuda(), cfg=src.cfg)
        if img.shape != tuple(want.shape) or not np.isfinite(img).all():
            fail(f"families {name}: response {img.shape}")
        worst = max(worst, float(np.abs(want.float().cpu().numpy()
                                        - img).max()))
    if worst > SERVED_TOL:
        fail(f"families {name}: responses differ from direct sampler calls "
             f"by {worst} > {SERVED_TOL}")
    images = np.load(npz)["images"]
    lo = 0
    for i, n in enumerate(gen["buckets"]):
        z = torch.from_numpy(generate.generate_z(GEN_SEED, i, n,
                                                 src.z_dim)).cuda()
        want = sampler_apply(src._params, src._state, z, cfg=src.cfg)
        take = min(n, GEN_IMAGES - lo)
        if not np.array_equal(want.float().cpu().numpy()[:take],
                              images[lo:lo + take]):
            fail(f"families {name}: generate batch {i} (rung {n}) differs "
                 "from the eager sampler on its z rows")
        lo += take
    src.close()

    art = os.path.join(workdir, f"{name}_sampler.pt2")
    side = export_sampler(run, art, device="cuda", max_serve_batch=BATCH)
    asrc = ArtifactSource(art, device="cuda")
    server = SamplerServer(asrc, buckets=FAM_RUNGS, max_batch=BATCH,
                           max_wait_ms=0.0)
    server.start()
    ref = CheckpointSource(run, device="cuda")
    ref.prepare()
    plain = dataclasses.replace(ref.cfg, use_pallas=False, bn_pallas=None)
    errs = {}
    for b in FAM_RUNGS:
        z = rng.uniform(-1.0, 1.0, (b, asrc.z_dim)).astype(np.float32)
        got = server.submit(z=z).result(timeout=60)
        want = sampler_apply(ref._params, ref._state,
                             torch.from_numpy(z).cuda(), cfg=plain)
        errs[b] = float(np.abs(got - want.float().cpu().numpy()).max())
    rungs = asrc.compiled_buckets()
    server.stop()
    if side["arch"] != ref.cfg.arch or rungs != FAM_RUNGS or \
            max(errs.values()) > SERVED_TOL:
        fail(f"families {name} artifact: {side['arch']}, rungs {rungs}, "
             f"|err| by rung {errs}")
    ref.close()

    result, timings = evals_cli(
        torch, ["--checkpoint_dir", run, "--synthetic", "--num_samples",
                str(FAM_EVAL_SAMPLES), "--batch_size", str(BATCH), "--kid",
                "--kid_pool", str(FAM_EVAL_SAMPLES), "--kid_subset_size",
                str(FAM_EVAL_SAMPLES // 4), "--device", "cuda"],
        None, kernels, per_replay, 1 + -(-FAM_EVAL_SAMPLES // BATCH))
    if not all(np.isfinite(result[k]) for k in ("fid", "kid")):
        fail(f"families {name} evals: {result}")
    report[f"{name}_serve"] = {
        "max_abs_err": worst, "artifact_max_abs_err": errs,
        "artifact_bytes": side["bytes"], "p50_ms": rep["serve/p50_ms"],
        "generate_buckets": gen["buckets"], "launches": launches,
        "rung_launches": per_rung[FAM_RUNGS[-1]],
        "evals": dict(result, seconds=timings)}
    log(f"families {name}: {FAM_DEMO_REQUESTS} demo requests through the "
        f"entry point; rungs {FAM_RUNGS} each capturing {want_rung}, served "
        f"within {worst:.3g} of direct sampler calls; generate on rungs "
        f"{gen['buckets']} equal to the eager sampler bit for bit; the "
        f"artifact ({side['bytes']} bytes) within {errs} of the plain "
        f"sampler; evals {result}; launches {launches}")


def families_and_check(torch, np, workdir, kernels):
    """Phase 21: sngan-cifar10 (the resnet family, gf = df = 64, batch 64)
    on the kernel route from `prepare --cifar10` shards, the routes and
    the captured step, WGAN-GP under use_pallas, the attention block on
    the flash kernels; stylegan64 (synthetic) with its lazy R1; both
    served, generated, exported and scored. Returns the `families`
    report."""
    from dcgan_tpu_torch.data import prepare
    from dcgan_tpu_torch.train import cli

    t0 = time.perf_counter()
    report = {"batch": BATCH}
    saved = torch.backends.cudnn.deterministic
    shards = os.path.join(workdir, "families_cifar10")
    prepare.main(["--cifar10", "--input_dir", cond_cifar_batches(
        np, os.path.join(workdir, "families_cifar_batches")),
        "--output_dir", shards, "--num_shards", str(COND_SHARDS)])
    data = ["--data_dir", shards, "--shuffle_buffer", str(2 * BATCH)]
    preset = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "sngan-cifar10", "--use_pallas"]))
    bns = len(resnet_bn_shapes(preset.model, BATCH))
    per_step = fam_per_step(preset.n_critic, bns)
    fam_check_kernels(torch, preset.model, BATCH, report)

    # sngan-cifar10 on the kernel route: hinge, n_critic 5, SN critic
    state, cfg, secs, rows = cond_cli(
        torch, np, "sngan_cifar10", cond_argv(
            workdir, "sngan_cifar10", "sngan-cifar10", FAM_STEPS,
            ["--use_pallas"] + data),
        FAM_STEPS, per_step, kernels, "sngan_cifar10", group="families",
        unmoved=HEAD_BIAS)
    del state
    report["sngan_cifar10"] = {"train_s": secs, "last": rows[-1],
                               "per_step": per_step}
    run = cfg.checkpoint_dir
    for dt_name in ("bfloat16", "float32"):
        rcfg = dataclasses.replace(cfg, precision={
            "bfloat16": "bf16", "float32": "f32"}[dt_name])
        a1_route_grads(torch, f"sngan_cifar10 {dt_name}", rcfg, report)
    a1_capture_compare(torch, "sngan_cifar10", cfg, FAM_COMPARE_STEPS)

    # WGAN-GP, the resnet family's own loss, with G's BN on the kernels
    _, _, secs, rows = cond_cli(
        torch, np, "resnet_wgan_gp", cond_argv(
            workdir, "resnet_wgan_gp", "sngan-cifar10", FAM_WGAN_STEPS,
            ["--use_pallas", "--loss", "wgan-gp"] + data),
        FAM_WGAN_STEPS, per_step, kernels, "resnet_wgan_gp",
        group="families", unmoved=HEAD_BIAS)
    if not all(r["gp"] > 0 for r in rows):
        fail(f"families resnet_wgan_gp: gp {[r['gp'] for r in rows]}")
    report["resnet_wgan_gp"] = {"train_s": secs,
                                "gp": [r["gp"] for r in rows]}
    fam_attention(torch, np, workdir, data, fam_per_step(
        preset.n_critic, bns, attn=True), kernels, report)

    # stylegan64: no port kernel; R1 at steps 0 and 16 only
    s_state, scfg, secs, rows = cond_cli(
        torch, np, "stylegan64", cond_argv(
            workdir, "stylegan64", "stylegan64", STYLEGAN_STEPS,
            ["--synthetic"]),
        STYLEGAN_STEPS, {name: 0 for name in PER_STEP}, kernels,
        "stylegan64", group="families", unmoved=HEAD_BIAS)
    del s_state
    r1 = [r["r1"] for r in rows]
    if [i for i, v in enumerate(r1) if v > 0] != \
            [i for i in range(STYLEGAN_STEPS) if i % scfg.r1_interval == 0]:
        fail(f"families stylegan64: r1 by step {r1}")
    report["stylegan64"] = {"train_s": secs, "r1": r1}
    a1_capture_compare(torch, "stylegan64", scfg, STYLEGAN_STEPS)

    # serving, generate, export and evals, bit for bit where compared so
    torch.backends.cudnn.deterministic = True
    fam_serve(torch, np, workdir, "sngan_cifar10", run, kernels, report,
              {"scale_shift_act": bns})
    fam_serve(torch, np, workdir, "stylegan64", scfg.checkpoint_dir,
              kernels, report, {})
    torch.backends.cudnn.deterministic = saved

    cond_timed(torch, "sngan_cifar10_step", cfg, report, group="families")
    cond_timed(torch, "stylegan64_step", scfg, report, group="families")
    report["seconds"] = time.perf_counter() - t0
    log(f"families: the group took {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# fault tolerance in one process (`faults`)
# ---------------------------------------------------------------------------

# celeba64 on the kernel route, captured (--aot_warmup), with the rollback
# armed: a snapshot every FAULT_SNAPSHOT steps, a NaN injected into the
# gate's view at FAULT_NAN_STEP (inside the K=4 call 4 -> 8), so the run
# restores step 4 and replays to FAULT_STEPS
FAULT_STEPS = 12
FAULT_SNAPSHOT = 4
FAULT_NAN_STEP = 7
# the steps the card runs in each rollback run: the NaN's step and the ones
# before it, then the replay from the snapshot
FAULT_EXECUTED = {1: FAULT_NAN_STEP + FAULT_STEPS - FAULT_SNAPSHOT,
                  4: 2 * FAULT_SNAPSHOT + FAULT_STEPS - FAULT_SNAPSHOT}
# the abort run's NaN, and the watchdog run's hang and deadline (seconds)
FAULT_ABORT_STEP = 5
FAULT_HANG_STEP = 3
FAULT_WATCHDOG_SECS = 5.0
# the async/inline services pair: a K=1 fed run with a JSONL and
# TensorBoard row every step, a grid and an activation summary every
# FAULT_TELEMETRY_EVERY steps
FAULT_TIMED_STEPS = 60
FAULT_TELEMETRY_EVERY = 20
# snapshot / restore timing: repetitions (the median is kept)
FAULT_REPS = 5
# --rollback_lr_backoff of the rollback run at K=k (none at K=1), and the
# scale the restore checks set after a restore
FAULT_BACKOFF = {4: 0.5}


def fault_argv(workdir, name, k, argv):
    """train.cli.main's arguments for the faults group's run `name`:
    celeba64 on the kernel route, synthetic, captured at K=k."""
    return cond_argv(workdir, f"faults_{name}", "celeba64", FAULT_STEPS,
                     ["--use_pallas", "--pallas_fused", "--synthetic",
                      "--steps_per_call", str(k), "--aot_warmup",
                      "--save_model_secs", "1e9", "--nan_check_steps",
                      "1"] + argv)


@contextlib.contextmanager
def chaos_plan(plan):
    """DCGAN_CHAOS set to `plan` for the block, read afresh by the port's
    chaos module (the contract the drill uses per subprocess)."""
    from dcgan_tpu_torch.testing import chaos

    os.environ["DCGAN_CHAOS"] = json.dumps(plan)
    chaos.reset()
    try:
        yield
    finally:
        os.environ.pop("DCGAN_CHAOS", None)
        chaos.reset()


def fault_rollback_run(torch, np, workdir, k, kernels, report):
    """The rollback run at K=k: exactly FAULT_EXECUTED[k] steps' launches
    of kernels 1-4 (the steps before the restore and the replayed ones,
    each at PER_STEP), the restore capturing nothing, anomaly/rollbacks 1
    from the failing step on, finite losses, the run at FAULT_STEPS."""
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.warmup import StepRunner

    backoff = FAULT_BACKOFF.get(k)
    argv = fault_argv(workdir, f"rollback_k{k}", k, [
        "--nan_policy", "rollback", "--rollback_snapshot_steps",
        str(FAULT_SNAPSHOT), "--max_rollbacks", "2"] + (
            [] if backoff is None else
            ["--rollback_lr_backoff", str(backoff)]))
    seen = []
    restore = StepRunner.restore

    def watched(self, manager, exc):
        before = self.captures
        step = restore(self, manager, exc)
        seen.append((self, before, step, getattr(exc, "step", None)))
        return step

    wrappers = all_wrappers()
    StepRunner.restore = watched
    try:
        with chaos_plan({"nan_at_step": FAULT_NAN_STEP}), \
                tee_stdout() as out:
            reset_counts(wrappers)
            t0 = time.perf_counter()
            state = cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        StepRunner.restore = restore
    launches = {n: fn.launches for n, fn in wrappers.items()}
    name = f"faults rollback K={k}"
    want = {n: PER_STEP[n] * FAULT_EXECUTED[k] for n in PER_STEP}
    if launches != want:
        fail(f"{name}: launches {launches}, expected {want} "
             f"({FAULT_EXECUTED[k]} steps at PER_STEP)")
    for entry in kernels:
        entry.setdefault("launches_by_path", {})[f"faults_k{k}"] = \
            launches[entry["name"]]
    if len(seen) != 1:
        fail(f"{name}: {len(seen)} restores, expected one")
    runner, before, step, fail_step = seen[0]
    if (step, fail_step) != (FAULT_SNAPSHOT, FAULT_NAN_STEP) or \
            runner.captures != before:
        fail(f"{name}: restored step {step} at failing step {fail_step}; "
             f"captures {before} before the restore, {runner.captures} "
             f"at the end")
    text = out.getvalue()
    if f"rolling back to last-good snapshot at step {FAULT_SNAPSHOT}" \
            not in text or int(state["step"]) != FAULT_STEPS:
        fail(f"{name}: no rollback line, or the run ended at step "
             f"{int(state['step'])}")
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    events = read_jsonl(os.path.join(cfg.checkpoint_dir, "events.jsonl"))
    rows = [(e["step"], e["values"]["anomaly/rollbacks"]) for e in events
            if e["kind"] == "scalars" and "anomaly/rollbacks" in e["values"]]
    losses = [e["values"] for e in events if e["kind"] == "scalars"
              and "d_loss" in e["values"]]
    if not rows or rows[0] != (FAULT_NAN_STEP, 1.0) or \
            any(v != 1.0 for _, v in rows) or not all(np.isfinite(
                [r[k2] for k2 in ("d_loss", "g_loss")]).all()
                for r in losses):
        fail(f"{name}: anomaly/rollbacks rows {rows}, or non-finite "
             f"losses")
    backoff_line = None
    if backoff is not None:
        # the backoff refilled the rate cells the captured rows read
        cells = runner.fns.lr_backoff
        got = {n: cells.cell(n, runner.device).item() for n in cells.rates}
        want = {n: torch.tensor(r * backoff, dtype=torch.float32).item()
                for n, r in cells.rates.items()}
        lines = [ln for ln in text.splitlines()
                 if "rollback LR backoff: base rates scaled by" in ln]
        if len(lines) != 1 or got != want:
            fail(f"{name}: backoff lines {lines}, rate cells {got}, "
                 f"expected {want}")
        backoff_line = lines[0]
    report[f"rollback_k{k}"] = {
        "train_s": secs, "launches": launches, "restored_step": step,
        "captures_at_restore": before, "captures_at_end": runner.captures,
        "anomaly_rows": rows, "backoff_line": backoff_line}
    log(f"{name}: NaN at {FAULT_NAN_STEP} restored step {step}, the run "
        f"reached {FAULT_STEPS} in {secs:.1f} s; {FAULT_EXECUTED[k]} steps' "
        f"launches {launches}; captures {before} -> {runner.captures}; "
        f"backoff {backoff_line}")


def fault_restore_checks(torch, k, report):
    """A runner at K=k (celeba64 kernel route, every row captured): the
    snapshot and the restore timed on the device (CUDA events) and the
    host; the restored static state equal to the snapshot bit for bit;
    the first replay after the restore equal to eager steps from the
    snapshot on the same inputs, bit for bit (losses and every leaf); the
    launches of kernels 1-4 of a replay after the restore equal to one
    before it; nothing captured."""
    from dcgan_tpu_torch.train.rollback import RollbackManager
    from dcgan_tpu_torch.train.steps import make_train_step, tree_leaves, \
        tree_map
    from dcgan_tpu_torch.train.warmup import StepRunner

    cfg = capture_cfg("celeba64", dict(use_pallas=True, pallas_fused=True),
                      k)
    fns = make_train_step(cfg)
    images, zs = step_inputs(torch, cfg, 1 + 3 * k)
    runner = StepRunner(fns, seeded_state(torch, fns, cfg), cfg,
                        torch.device("cuda"))
    runner.step(images[:1], zs[:1])                  # the warm-up
    runner.capture(runner.row(k))
    wrappers = all_wrappers()
    manager = RollbackManager(every=1, max_rollbacks=10 ** 6, chief=False)
    fresh = runner.row(k)
    before_ix = slice(1, 1 + k)
    after_ix = slice(1 + k, 1 + 2 * k)
    reset_counts(wrappers)
    runner.step(images[before_ix], zs[before_ix]).tolist()
    per_replay = {n: fn.launches for n, fn in wrappers.items()}
    captures = runner.captures
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3, \
            out

    snap, rest, back = [], [], []
    err = FloatingPointError("faults: injected")
    for _ in range(FAULT_REPS):
        snap.append(timed(lambda: manager.snapshot(1 + k, runner.state)))
        # the live state moves on, then the restore takes it back
        runner.step(images[after_ix], zs[after_ix]).tolist()
        rest.append(timed(lambda: runner.restore(manager, err)))
    saved = [t.clone() for t in tree_leaves(manager._snap)]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(runner.state),
                                                 saved))
    if not same:
        fail(f"faults K={k}: the restored static state differs from the "
             "snapshot")
    reset_counts(wrappers)
    t0 = time.perf_counter()
    runner.restore(manager, err)
    replay = runner.step(images[after_ix], zs[after_ix]).tolist()
    back_ms = (time.perf_counter() - t0) * 1e3
    after = {n: fn.launches for n, fn in wrappers.items()}
    if after != per_replay:
        fail(f"faults K={k}: a replay after the restore launched {after}, "
             f"one before it {per_replay}")
    replayed = [t.clone() for t in tree_leaves(runner.state)]
    state, losses = eager_steps(fns, tree_map(torch.clone, manager._snap),
                                images[after_ix], zs[after_ix])
    if losses != replay or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                              replayed)):
        fail(f"faults K={k}: the first replay after the restore "
             f"({replay[-1]}) differs from eager steps from the snapshot "
             f"({losses[-1]})")
    # the LR backoff after a restore: the replay reads the refilled rate
    # cells by address, so it equals eager steps from the snapshot at the
    # backed-off rates and differs from the replay at the base rates
    runner.restore(manager, err)
    runner.set_lr_scale(FAULT_BACKOFF[CAPTURE_K])
    backed = runner.step(images[after_ix], zs[after_ix]).tolist()
    backed_state = [t.clone() for t in tree_leaves(runner.state)]
    state, losses = eager_steps(fns, tree_map(torch.clone, manager._snap),
                                images[after_ix], zs[after_ix])
    runner.set_lr_scale(1.0)
    if losses != backed or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                              backed_state)):
        fail(f"faults K={k}: the replay after the restore and the LR "
             f"backoff ({backed[-1]}) differs from eager steps from the "
             f"snapshot at the backed-off rates ({losses[-1]})")
    if all(torch.equal(a, b) for a, b in zip(backed_state, replayed)):
        fail(f"faults K={k}: the replay at the backed-off rates left the "
             "state of the replay at the base rates")
    if runner.captures != captures or runner.row(k) != fresh:
        fail(f"faults K={k}: the restores and the backoff captured "
             f"{runner.captures - captures} program(s)")
    for _ in range(2):
        back.append(timed(lambda: (runner.restore(manager, err),
                                   runner.step(images[after_ix],
                                               zs[after_ix]).tolist())))
    med = statistics.median
    entry = {
        "snapshot_device_ms": med(d for d, _, _ in snap),
        "snapshot_host_ms": med(h for _, h, _ in snap),
        "restore_device_ms": med(d for d, _, _ in rest),
        "restore_host_ms": med(h for _, h, _ in rest),
        "rollback_to_next_replay_ms": med(
            [back_ms] + [h for _, h, _ in back]),
        "state_bytes": sum(t.numel() * t.element_size() for t in saved),
        "leaves": len(saved), "launches_per_replay": per_replay}
    report[f"restore_k{k}"] = entry
    log(f"faults K={k}: snapshot {entry['snapshot_device_ms']:.3f} ms "
        f"device ({entry['snapshot_host_ms']:.3f} host), restore "
        f"{entry['restore_device_ms']:.3f} ms device "
        f"({entry['restore_host_ms']:.3f} host) over "
        f"{entry['state_bytes'] / 2 ** 20:.1f} MiB in {entry['leaves']} "
        f"leaves; rollback to the next replay's readback "
        f"{entry['rollback_to_next_replay_ms']:.3f} ms; restored state and "
        f"the first replay equal the snapshot and eager steps bit for "
        f"bit, also after an LR backoff to "
        f"{FAULT_BACKOFF[CAPTURE_K]}; launches per replay {per_replay} "
        f"before and after; 0 captures")
    runner.close()
    del runner, manager
    torch.cuda.empty_cache()


def fault_pipeline_run(torch, np, workdir, report):
    """The rollback under --pipeline_gd: the restore drains the fake stack
    in flight, and the run completes."""
    from dcgan_tpu_torch.train import cli

    argv = fault_argv(workdir, "pipeline", 1, [
        "--pipeline_gd", "true", "--nan_policy", "rollback",
        "--rollback_snapshot_steps", str(FAULT_SNAPSHOT)])
    with chaos_plan({"nan_at_step": FAULT_NAN_STEP}), tee_stdout() as out:
        t0 = time.perf_counter()
        state = cli.main(argv)
        secs = time.perf_counter() - t0
    text = out.getvalue()
    if "rollback drained the in-flight pipelined fake stack" not in text \
            or int(state["step"]) != FAULT_STEPS:
        fail(f"faults pipeline: no drain line, or the run ended at step "
             f"{int(state['step'])}")
    report["pipeline"] = {"train_s": secs, "drained": True}
    log(f"faults pipeline: the rollback at {FAULT_NAN_STEP} drained the "
        f"fake stack, the run reached {FAULT_STEPS} in {secs:.1f} s")


def fault_abort_run(torch, workdir, report):
    """A NaN under the abort policy: FloatingPointError at the step, and a
    flight-recorder dump whose last record is that step, gate "trip"."""
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.flight_recorder import read_dump, \
        recorder_path

    argv = fault_argv(workdir, "abort", 1, [])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    with chaos_plan({"nan_at_step": FAULT_ABORT_STEP}):
        try:
            cli.main(argv)
        except FloatingPointError as e:
            if getattr(e, "step", None) != FAULT_ABORT_STEP:
                fail(f"faults abort: raised at step {getattr(e, 'step')}")
        else:
            fail("faults abort: the NaN did not abort the run")
    header, records = read_dump(recorder_path(cfg.checkpoint_dir))
    if header["reason"] != "nan-abort" or header["step"] != \
            FAULT_ABORT_STEP or not records or \
            (records[-1]["step"], records[-1]["gate"]) != \
            (FAULT_ABORT_STEP, "trip"):
        fail(f"faults abort: dump {header}, last record {records[-1:]}")
    report["abort"] = {"dump_records": len(records),
                       "last": records[-1]["step"]}
    log(f"faults abort: FloatingPointError at {FAULT_ABORT_STEP}, a dump of "
        f"{len(records)} records, the last step {FAULT_ABORT_STEP} 'trip'")


def fault_watchdog_run(workdir, report):
    """`python -m dcgan_tpu_torch.train` in a subprocess with the watchdog
    armed and a hang at FAULT_HANG_STEP inside the guarded dispatch: exit
    43, every thread's stack on stderr, and a dump naming the phase."""
    from dcgan_tpu_torch.train.flight_recorder import read_dump

    tdir = os.path.join(workdir, "faults_watchdog")
    env = dict(os.environ, DCGAN_CHAOS=json.dumps(
        {"hang_at_step": FAULT_HANG_STEP, "hang_secs": 600}))
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dcgan_tpu_torch.train", "--preset",
         "celeba64", "--use_pallas", "--pallas_fused", "--synthetic",
         "--max_steps", "20", "--batch_size", str(BATCH), "--device",
         "cuda", "--checkpoint_dir", tdir, "--sample_every_steps", "0",
         "--activation_summary_steps", "0", "--save_model_secs", "1e9",
         "--collective_timeout_secs", str(FAULT_WATCHDOG_SECS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if res.returncode != 43 or "hung-collective watchdog" not in \
            res.stderr or "Thread 0x" not in res.stderr:
        fail(f"faults watchdog: rc {res.returncode}, stderr "
             f"{res.stderr[-1500:]}")
    header, records = read_dump(os.path.join(tdir, "flight_recorder.jsonl"))
    if (header["reason"], header.get("phase"), header["step"]) != \
            ("watchdog", "step-dispatch", FAULT_HANG_STEP) or not records:
        fail(f"faults watchdog: dump header {header}")
    report["watchdog"] = {"rc": res.returncode, "seconds": secs,
                          "dump_records": len(records)}
    log(f"faults watchdog: exit 43 after {secs:.1f} s (deadline "
        f"{FAULT_WATCHDOG_SECS} s), stacks on stderr, a dump of "
        f"{len(records)} records naming 'step-dispatch' at step "
        f"{FAULT_HANG_STEP}")


def fault_services_pair(torch, np, workdir, report):
    """The same fed K=1 run with the services async and inline, in turns
    (async, inline, inline, async): the same JSONL but for the wall-clock
    fields; each run's step ms (the trainer's own p50 and mean,
    host-inclusive) against the captured step's busy ms, and the idle
    share."""
    from dcgan_tpu_torch.train import cli

    out = {}
    # in turns, async first and last
    for turn, mode in enumerate(("true", "false", "false", "true")):
        argv = cond_argv(workdir, f"faults_services_{mode}{turn}",
                         "celeba64",
                         FAULT_TIMED_STEPS, [
                             "--use_pallas", "--pallas_fused",
                             "--synthetic", "--aot_warmup",
                             "--save_model_secs", "1e9",
                             "--nan_check_steps", "1",
                             "--async_services", mode,
                             "--sample_every_steps",
                             str(FAULT_TELEMETRY_EVERY),
                             "--activation_summary_steps",
                             str(FAULT_TELEMETRY_EVERY)])
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        t0 = time.perf_counter()
        cli.main(argv)
        secs = time.perf_counter() - t0
        events = read_jsonl(os.path.join(cfg.checkpoint_dir,
                                         "events.jsonl"))
        last = [e["values"] for e in events if e["kind"] == "scalars"
                and "perf/step_ms_p50" in e["values"]][-1]
        text = json.dumps([{k: v for k, v in e.items() if k != "time"}
                           | ({"values": {a: b for a, b in
                                          e["values"].items()
                                          if not a.startswith("perf/")}}
                              if isinstance(e.get("values"), dict) else {})
                           for e in events]).replace(cfg.checkpoint_dir,
                                                     "D")
        text = text.replace(f"faults_services_{mode}{turn}", "R")
        o = out.setdefault(mode, {"texts": [], "train_s": [],
                                  "step_ms_p50": [], "step_ms_mean": [],
                                  "host_ms_mean": []})
        o["texts"].append(text)
        o["events"] = len(events)
        o["train_s"].append(secs)
        for key in ("step_ms_p50", "step_ms_mean", "host_ms_mean"):
            o[key].append(last[f"perf/{key}"])
    texts = set(out["true"].pop("texts") + out["false"].pop("texts"))
    if len(texts) != 1:
        fail(f"faults services: the async and inline runs wrote "
             f"{len(texts)} different JSONL streams")
    cfg = capture_cfg("celeba64", dict(use_pallas=True, pallas_fused=True))
    cond_timed(torch, "faults_step", cfg, report, group="faults")
    busy = report["faults_step"]["busy_ms"]
    for mode, name in (("true", "async"), ("false", "inline")):
        o = out[mode]
        o["busy_ms"] = busy
        o["idle_share"] = [max(0.0, 1.0 - busy / ms)
                           for ms in o["step_ms_p50"]] \
            if isinstance(busy, float) else "not measured"
        report[f"services_{name}"] = o
    log(f"faults services: async and inline JSONL equal "
        f"({out['true']['events']} events); step ms p50 in turns async "
        f"{out['true']['step_ms_p50'][0]:.3f}, inline "
        f"{out['false']['step_ms_p50']}, async "
        f"{out['true']['step_ms_p50'][1]:.3f}; busy {busy} ms; idle share "
        f"async {out['true']['idle_share']}, inline "
        f"{out['false']['idle_share']}")


def faults_and_check(torch, np, workdir, kernels):
    """Phase 22: one-process fault tolerance on celeba64's kernel route
    (gf = df = 64, batch 64, captured). Returns the `faults` report."""
    t0 = time.perf_counter()
    report = {"batch": BATCH}
    saved = torch.backends.cudnn.deterministic
    # the bit-for-bit comparisons (eager against replay, async against
    # inline runs) need cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    try:
        for k in (1, CAPTURE_K):
            fault_rollback_run(torch, np, workdir, k, kernels, report)
            fault_restore_checks(torch, k, report)
        fault_pipeline_run(torch, np, workdir, report)
        fault_abort_run(torch, workdir, report)
        fault_services_pair(torch, np, workdir, report)
    finally:
        torch.backends.cudnn.deterministic = saved
    fault_watchdog_run(workdir, report)
    report["seconds"] = time.perf_counter() - t0
    log(f"faults: the group took {report['seconds']:.1f} s")
    return report


# The trainer's own trace capture (`trace`): celeba64 on the kernel route
# (gf = df = 64, batch 64, bf16, K=1, --aot_warmup, synthetic feed), a
# scheduled window and one triggered window, then a pipelined run with a
# scheduled window
TRACE_STEPS = 20
TRACE_START = 3
TRACE_WINDOW = 5
# the boundary at which the trigger file is touched (between two calls)
TRACE_TRIGGER_AT = 12
TRACE_PIPE_STEPS = 10
# the window's device step against the profiled busy ms of the same
# captured step (below) and the run's host-inclusive p50 (above)
TRACE_STEP_BOUNDS = (0.9, 1.1)
TRACE_TOP = 10
# a port kernel's entry in a trace (a part of its name) -> its wrapper
TRACE_ENTRIES = dict(PROFILE_ENTRIES,
                     gbsa_wgmma_kernel="gemm_bias_scale_act")


def trace_argv(workdir, name, steps, argv):
    return cond_argv(workdir, name, "celeba64", steps, [
        "--use_pallas", "--pallas_fused", "--synthetic", "--aot_warmup",
        "--save_model_secs", "1e9", "--log_every_steps", "1",
        "--timing_window", "1", "--profile_dir",
        os.path.join(workdir, name, "traces"), "--profile_start_step",
        str(TRACE_START), "--profile_num_steps", str(TRACE_WINDOW)] + argv)


def kineto_tracks(events):
    """What Kineto names the tracks of a GPU capture: the process and
    thread names of the pids that hold device ops, the categories of the
    X events, and one device annotation's args."""
    from dcgan_tpu_torch.utils import trace as tr

    _, ops, _ = tr.select_device_tracks(events)
    pids = {e["pid"] for e in ops}
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("pid") in pids and e.get("name") in (
                "process_name", "process_labels", "thread_name"):
            names.setdefault(e["name"], set()).add(
                str(next(iter(e.get("args", {}).values()), "")))
    cats = {}
    for e in events:
        if e.get("ph") == "X":
            key = f"{e.get('cat')}@{'device' if e['pid'] in pids else 'host'}"
            cats[key] = cats.get(key, 0) + 1
    ann = next((e for e in events if e.get("cat") == "gpu_user_annotation"),
               None)
    return {"device_pids": sorted(map(str, pids)),
            "names": {k: sorted(v)[:6] for k, v in names.items()},
            "cats": cats, "annotation": ann}


def window_kernels(events):
    """{wrapper: launches} of the port kernels in one window's trace, the
    window's TRACE_TOP costliest kernels by total device ms, and its
    timeline: the port kernels inside each program execution, and the us
    from each graph launch (host clock) to the first device op after it
    (device clock)."""
    from dcgan_tpu_torch.utils import trace as tr

    programs, ops, _ = tr.select_device_tracks(events)
    counts = {w: 0 for w in all_wrappers()}
    by_name = {}
    port = []
    for e in ops:
        if e.get("cat") != "kernel":
            continue
        for part, wrapper in TRACE_ENTRIES.items():
            if part in e["name"]:
                counts[wrapper] += 1
                port.append(e["ts"])
        t = by_name.setdefault(e["name"][:100], [0.0, 0])
        t[0] += e["dur"] / 1e3
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP]
    starts = sorted(e["ts"] for e in ops)
    launches = sorted(e["ts"] for e in events if e.get("ph") == "X" and
                      e.get("cat") == "cuda_runtime"
                      and "GraphLaunch" in e["name"])
    timeline = {
        "port_kernels_per_program": [
            sum(p["ts"] <= t <= p["ts"] + p["dur"] for t in port)
            for p in programs],
        "launch_to_first_op_us": [
            round(next((t for t in starts if t >= ts), float("nan")) - ts, 1)
            for ts in launches]}
    return counts, [{"name": n, "ms": ms, "n": c} for n, (ms, c) in top], \
        timeline


def trace_run(torch, np, workdir, name, steps, argv, windows):
    """One train.cli.main run of the group with the wrappers' counters
    read around each window's recorded steps (TraceCapture's open, the
    end of its warm-up call and its stop patched) and the trigger touched
    at the boundary TRACE_TRIGGER_AT. Returns (cfg, stdout, events)."""
    from dcgan_tpu_torch.graphs import counts_delta, launch_counts
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.utils.profiling import TraceCapture

    cls = TraceCapture
    begin, record, end, start = \
        cls._begin, cls._record, cls._end, cls.maybe_start

    def patched_begin(self, step):
        windows.append({"run": name, "open": step})
        begin(self, step)

    def patched_record(self, step):
        windows[-1].update(start=step, before=launch_counts())
        record(self, step)

    def patched_end(self):
        end(self)
        w = windows[-1]
        w["delta"] = {n: c for n, (c, _) in counts_delta(
            launch_counts(), w.pop("before")).items()}
        w["stop"] = self._stop_at
        w["stop_ms"] = self.last_stop_ms

    def patched_start(self, step):
        if self.trigger_path and step == TRACE_TRIGGER_AT:
            with open(self.trigger_path, "w"):
                pass
        start(self, step)

    argv = trace_argv(workdir, name, steps, argv)
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    cls._begin, cls._record, cls._end, cls.maybe_start = \
        patched_begin, patched_record, patched_end, patched_start
    try:
        with tee_stdout() as out:
            state = cli.main(argv)
    finally:
        cls._begin, cls._record, cls._end, cls.maybe_start = \
            begin, record, end, start
    if int(state["step"]) != steps:
        fail(f"trace {name}: the run ended at step {int(state['step'])}")
    events = read_jsonl(os.path.join(cfg.checkpoint_dir, "events.jsonl"))
    return cfg, out.getvalue(), events


def trace_digests(text):
    """The trainer's `trace digest` lines: {field: value} each."""
    out = []
    for line in text.splitlines():
        if "] trace digest (ending step" not in line:
            continue
        m = re.search(r"ending step (\d+), (\w+) track, top program "
                      r"'([^']*)' x(\d+)\): (.*)$", line)
        if m is None:
            fail(f"trace: unreadable digest line {line!r}")
        d = {"step": int(m.group(1)), "source": m.group(2),
             "program": m.group(3), "program_n": int(m.group(4))}
        for part in m.group(5).split():
            k, v = part.split("=", 1)
            d[k] = v if k == "trace" else float(v)
        out.append(d)
    return out


def trace_and_check(torch, np, workdir, kernels):
    """Phase 23: the trainer's trace capture on the card. Returns the
    `trace` report."""
    from dcgan_tpu_torch.utils import trace as tr

    t0 = time.perf_counter()
    report = {"batch": BATCH}
    trigger = os.path.join(workdir, "trace_trigger")
    wrappers = all_wrappers()
    windows = []
    reset_counts(wrappers)
    cfg, text, events = trace_run(torch, np, workdir, "trace_main",
                                  TRACE_STEPS, ["--profile_trigger",
                                                trigger], windows)
    pipe_cfg, pipe_text, pipe_events = trace_run(
        torch, np, workdir, "trace_pipe", TRACE_PIPE_STEPS,
        ["--pipeline_gd"], windows)
    launches = {n: fn.launches for n, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["trace"] = \
            launches[entry["name"]]
    for name in TRAIN_ONLY:
        if not launches[name]:
            fail(f"trace: kernel {name} never launched on the traced runs")
    digests = trace_digests(text)
    pipe_digests = trace_digests(pipe_text)
    rows = [(e["step"], e["values"]) for e in events
            if e["kind"] == "scalars" and "perf/device/step_ms"
            in e["values"]]
    pipe_rows = [(e["step"], e["values"]) for e in pipe_events
                 if e["kind"] == "scalars" and "perf/device/step_ms"
                 in e["values"]]
    # (d) two captures, the trigger consumed, two digest rows
    main_windows = [w for w in windows if w["run"] == "trace_main"]
    if len(main_windows) != 2 or len(digests) != 2 or len(rows) != 2:
        fail(f"trace: {len(main_windows)} captures, {len(digests)} digest "
             f"lines, {len(rows)} perf/device rows (expected 2 each)")
    if os.path.exists(trigger):
        fail("trace: the trigger file was not consumed")
    if [w["open"] for w in main_windows] != [
            TRACE_START, TRACE_TRIGGER_AT] or any(
            w["stop"] - w["start"] != TRACE_WINDOW for w in windows):
        fail(f"trace: windows {windows}")
    if len(pipe_digests) != 1 or len(pipe_rows) != 1:
        fail(f"trace: the pipelined run wrote {len(pipe_digests)} digest "
             f"lines and {len(pipe_rows)} rows")
    # (a) the GPU track
    for d in digests + pipe_digests:
        if d["source"] != "gpu":
            fail(f"trace: the digest read the {d['source']} track: {d}")
    tracks = None
    per_window = []
    for w, d in zip(windows, digests + pipe_digests):
        evs = tr.load_events(d["trace"])
        if tracks is None:
            tracks = kineto_tracks(evs)
            log(f"trace: Kineto's tracks of a GPU window: {tracks}")
        counts, top, timeline = window_kernels(evs)
        log(f"trace window {w['run']} at {w['start']}: {timeline}")
        # (b) each port kernel's launches in the trace = the counters
        if counts != w["delta"]:
            fail(f"trace: window at step {w['start']} of {w['run']}: port "
                 f"kernels in the trace {counts}, the counters "
                 f"{w['delta']}")
        per_window.append({"run": w["run"], "open": w["open"],
                           "start": w["start"], "stop": w["stop"],
                           "launches": counts, "top_kernels": top,
                           "timeline": timeline,
                           "stop_ms": w["stop_ms"],
                           "trace_bytes": int(d["trace_bytes"]),
                           "digest_s": d["digest_s"],
                           "digest_stop_ms": d["stop_ms"]})
    # (e) the pipelined window's step is the sum of its stages
    pd = tr.digest(pipe_digests[0]["trace"])
    stages = {r["program"]: r["ms_median"] for r in pd["rows"]}
    want = sum(v for k, v in stages.items()
               if "d_update" in k or "g_update" in k)
    got = pipe_rows[0][1]["perf/device/step_ms"]
    if not ({"d_update", "g_update"} <= set(stages)) or \
            abs(got - want) > 1e-9 * max(1.0, want):
        fail(f"trace: the pipelined step_ms {got} is not its stages' sum "
             f"{want} ({stages})")
    # (f) the startup row
    startup = [v for _, v in ((e["step"], e["values"]) for e in events
               if e["kind"] == "scalars")
               if "perf/startup/total_ms" in v]
    phases = ("init", "restore", "data", "warmup")
    if len(startup) != 1 or any(f"perf/startup/{p}_ms" not in startup[0]
                                for p in phases):
        fail(f"trace: startup rows {startup}")
    startup = startup[0]
    if startup["perf/startup/total_ms"] < sum(
            startup[f"perf/startup/{p}_ms"] for p in phases):
        fail(f"trace: startup total below the phases' sum: {startup}")
    # per-step host ms (timing_window 1): inside the windows (the warm-up
    # call's step too: the profiler runs) and outside
    inside = set()
    for w in main_windows:
        inside |= set(range(w["open"] + 1, w["stop"] + 1))
    step_ms = {e["step"]: e["values"]["perf/step_ms_p50"] for e in events
               if e["kind"] == "scalars"
               and "perf/step_ms_p50" in e["values"]}
    p50_in = statistics.median(v for s, v in step_ms.items() if s in inside)
    p50_out = statistics.median(v for s, v in step_ms.items()
                                if s not in inside and s > 2)
    # (c) the device step between the profiled busy ms and the host p50
    cond_timed(torch, "trace_step", capture_cfg(
        "celeba64", dict(use_pallas=True, pallas_fused=True)), report,
        group="trace")
    busy = report["trace_step"]["busy_ms"]
    if not isinstance(busy, float):
        fail("trace: the captured step's profile holds no device time")
    lo, hi = TRACE_STEP_BOUNDS
    for s, v in rows:
        dev_ms = v["perf/device/step_ms"]
        if not lo * busy <= dev_ms <= hi * p50_out:
            fail(f"trace: perf/device/step_ms {dev_ms:.3f} at step {s} "
                 f"outside [{lo} x busy {busy:.3f}, {hi} x host p50 "
                 f"{p50_out:.3f}]")
    # (g) the offline tool on a written trace
    res = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tools", "trace_summary_torch.py"),
         digests[0]["trace"]], capture_output=True, text=True, timeout=120)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"trace: tools/trace_summary_torch.py exited {res.returncode}: "
             f"{res.stderr[-500:]}")
    summary_rows = [json.loads(line) for line in res.stdout.splitlines()]
    report.update({
        "windows": per_window, "rows": [v for _, v in rows],
        "pipe_row": pipe_rows[0][1], "pipe_stages": stages,
        "startup": startup, "step_ms_p50_in_windows": p50_in,
        "step_ms_p50_outside": p50_out, "busy_ms": busy,
        "summary_rows": summary_rows[:4], "summary_note":
        res.stderr.strip()[-300:], "tracks": {
            k: v for k, v in (tracks or {}).items() if k != "annotation"},
        "launches": launches})
    for (s, v), w in zip(rows + pipe_rows, per_window):
        top = [(t["name"][:60], round(t["ms"], 3), t["n"])
               for t in w["top_kernels"]]
        log(f"trace window {w['run']} opened at {w['open']}, recorded "
            f"steps {w['start']}-{s}: compute "
            f"{v['perf/device/compute_ms']:.3f} ms, idle gap "
            f"{v['perf/device/idle_gap_ms']:.3f} ms, span "
            f"{v['perf/device/span_ms']:.3f} ms, step "
            f"{v['perf/device/step_ms']:.3f} ms; stop and export "
            f"{w['stop_ms']:.1f} ms, {w['trace_bytes']} bytes, digest "
            f"{w['digest_s']:.3f} s; port kernels {w['launches']}; top "
            f"{top}")
    log(f"trace: host step p50 {p50_in:.3f} ms inside the windows, "
        f"{p50_out:.3f} outside; the captured step's busy {busy:.3f} ms; "
        f"startup {startup}; trace_summary_torch rows "
        f"{[(r['program'], r['n'], r['ms_median']) for r in summary_rows]}")
    report["seconds"] = time.perf_counter() - t0
    log(f"trace: the group took {report['seconds']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# data parallelism over processes (`multi_gpu`)
# ---------------------------------------------------------------------------

# (a) celeba64 on the kernel route through the world-1 NCCL path: the
# warm-up and the steps captured at K = 1, then calls at K = CAPTURE_K
MG_STEPS = 3
# (b) sagan256-lc through the trainer CLI at world size 1 (NCCL)
MG_SAGAN_STEPS = 3
# (c) lsun64-dp8's 8 ranks over gloo on the one card, eager steps, and
# the world's deadline
MG_DP8_STEPS = 2
MG_DP8_TIMEOUT = 420.0
# the kernels of the steps each path runs per step (PER_STEP: kernels 1-4)
MG_KERNELS = ("channel_moments", "scale_shift_act", "scale_shift_act_bwd",
              "gemm_bias_moments")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_per_call(torch, fn):
    """(NCCL kernels, their device ms) in one call of fn() (after one
    untraced call), from torch.profiler's device events. Over one rank
    NCCL reduces in place without a launch, so a world-1 step shows
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [e for e in prof.events() if device_op(e)
             and "nccl" in e.name.lower()]
    return len(found), sum(e.time_range.elapsed_us() for e in found) / 1e3


def mg_world_one(torch, np, report, kernels):
    """(a): the world-1 NCCL step against the non-distributed one, both
    captured, bit for bit; kernels 1-4 per step on both; the NCCL kernels
    a replay holds; each route's host, busy ms and idle share."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.parallel.api import make_parallel_train
    from dcgan_tpu_torch.parallel.collectives import COUNTS
    from dcgan_tpu_torch.parallel.distributed import initialize_multihost
    from dcgan_tpu_torch.train.steps import make_train_step
    from dcgan_tpu_torch.train.warmup import StepRunner

    # one card, one host: NCCL's bootstrap over the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    world = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                 device="cuda:0")
    if (world.backend, world.size) != ("nccl", 1):
        fail(f"multi_gpu (a): world {world}")
    log(f"multi_gpu (a): initialize_multihost formed an NCCL world of "
        f"{world.size} on {world.device}")
    wrappers = all_wrappers()
    overrides = {"use_pallas": True, "pallas_fused": True}
    entry = {}
    launches_total = dict.fromkeys(MG_KERNELS, 0)
    for k in (1, CAPTURE_K):
        cfg = capture_cfg("celeba64", overrides, k)
        par = make_parallel_train(cfg, world)
        fns = make_train_step(cfg)
        runners = {"nccl": StepRunner(par.fns, seeded_state(torch, fns, cfg),
                                      cfg, torch.device("cuda")),
                   "plain": StepRunner(fns, seeded_state(torch, fns, cfg),
                                       cfg, torch.device("cuda"))}
        n = 1 + MG_STEPS * k
        images, zs = step_inputs(torch, cfg, n)
        calls = [(0, 1)] + [(1 + i * k, k) for i in range(MG_STEPS)]
        per_call = {}
        for start, size in calls:
            got = {}
            for name, runner in runners.items():
                reset_counts(wrappers)
                before = COUNTS["all_reduce"] + COUNTS["all_gather"]
                losses = runner.step(images[start:start + size],
                                     zs[start:start + size],
                                     start=start).tolist()
                torch.cuda.synchronize()
                got[name] = (losses, {w: wrappers[w].launches
                                      for w in MG_KERNELS},
                             COUNTS["all_reduce"] + COUNTS["all_gather"]
                             - before)
            if got["nccl"][0] != got["plain"][0]:
                fail(f"multi_gpu (a) K={k}: losses {got['nccl'][0]} vs "
                     f"{got['plain'][0]} at step {start}")
            same_state(torch, convert, f"multi_gpu (a) K={k} step {start}",
                       runners["nccl"].state, runners["plain"].state)
            for name in runners:
                want = {w: PER_STEP[w] * size for w in MG_KERNELS}
                if got[name][1] != want:
                    fail(f"multi_gpu (a) K={k} {name}: kernels 1-4 "
                         f"launched {got[name][1]}, expected {want}")
            for w in MG_KERNELS:
                launches_total[w] += got["nccl"][1][w]
            per_call[start] = got["nccl"][2]
        captured = sorted(runners["nccl"].programs)
        if not captured:
            fail(f"multi_gpu (a) K={k}: nothing was captured")
        # the collectives the step issues: on the host in the warm-up and
        # in the capture (K steps), none in a replay (they are the graph's)
        per_step = per_call[0]
        want = [per_step, per_step * k] + [0] * (MG_STEPS - 1)
        if per_step < 1 or list(per_call.values()) != want:
            fail(f"multi_gpu (a) K={k}: collectives issued per call "
                 f"{per_call}, expected {want}")
        prog = runners["nccl"].programs[runners["nccl"].row(k)]
        n_nccl, nccl_ms = nccl_per_call(torch, prog.run)
        prof = {name: replay_profile(torch, r, k)
                for name, r in runners.items()}
        e = entry[f"k{k}"] = {
            "steps": 1 + MG_STEPS * k, "captured": captured,
            "collectives_per_step": per_step,
            "nccl_kernels_per_replay": n_nccl,
            "nccl_ms_per_replay": nccl_ms,
            "host_collectives_per_call": per_call,
            **{f"{name}_{key}": p[key] for name, p in prof.items()
               for key in ("busy_ms", "wall_ms", "idle_share")}}
        log(f"multi_gpu (a) celeba64 K={k}: {e['steps']} steps of the "
            f"world-1 NCCL runner equal the non-distributed runner bit for "
            f"bit (losses and every state leaf), kernels 1-4 at "
            f"{ {w: PER_STEP[w] for w in MG_KERNELS} } a step on both; the "
            f"step issues {per_step} collectives (in the warm-up and the "
            f"capture; none from the host in a replay); a replay "
            f"({prog.name}) holds {n_nccl} NCCL kernels, {nccl_ms:.4f} ms "
            f"(none over one rank); per step: NCCL route busy "
            f"{e['nccl_busy_ms']:.3f} ms, host {e['nccl_wall_ms']:.3f} ms, "
            f"idle {e['nccl_idle_share']:.3f}; non-distributed busy "
            f"{e['plain_busy_ms']:.3f} ms, host {e['plain_wall_ms']:.3f} "
            f"ms, idle {e['plain_idle_share']:.3f}")
        for r in runners.values():
            r.close()
        del runners
        torch.cuda.empty_cache()
    report["celeba64_world1"] = entry
    for e in kernels:
        e.setdefault("launches_by_path", {})["multi_gpu_celeba64_w1"] = \
            launches_total.get(e["name"], 0)
    return world


def mg_sagan256(torch, np, workdir, report, kernels):
    """(b): `python -m dcgan_tpu_torch.train --preset sagan256-lc` at
    world size 1 over NCCL (the world (a) formed), a few steps on the
    synthetic feed; kernels 6-8 at the shapes the path gave them, held
    against their plain versions over FLASH_ROWS rows and timed beside
    their bound; the step captured (if it fits) and profiled."""
    import dataclasses as dc

    from dcgan_tpu_torch.ops import attention, flash_attention as fa
    from dcgan_tpu_torch.parallel.api import make_parallel_train
    from dcgan_tpu_torch.parallel.distributed import initialize_multihost
    from dcgan_tpu_torch.train import cli
    from dcgan_tpu_torch.train.warmup import StepRunner

    tdir = os.path.join(workdir, "sagan256_lc")
    argv = ["--preset", "sagan256-lc", "--synthetic", "--max_steps",
            str(MG_SAGAN_STEPS), "--device", "cuda", "--checkpoint_dir",
            tdir, "--sample_dir", os.path.join(workdir, "sagan256_samples"),
            "--seed", str(SEED), "--sample_every_steps", "0",
            "--activation_summary_steps", "0", "--save_model_secs", "1e9"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    m = cfg.model
    if (m.output_size, cfg.batch_size, m.attn_res, cfg.backend) != \
            (256, 64, 128, "shard_map"):
        fail(f"multi_gpu (b): sagan256-lc is {m}, batch {cfg.batch_size}, "
             f"{cfg.backend}")
    shapes = set()
    real = attention.flash_attention

    def recording(q, k, v, scale):
        shapes.add((tuple(q.shape), tuple(v.shape), str(q.dtype)[6:]))
        return real(q, k, v, scale)

    wrappers = all_wrappers()
    reset_counts(wrappers)
    attention.flash_attention = recording
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        attention.flash_attention = real
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if launches[name] < MG_SAGAN_STEPS or \
                launches[name] % MG_SAGAN_STEPS:
            fail(f"multi_gpu (b): {name} launched {launches[name]} times "
                 f"over {MG_SAGAN_STEPS} steps")
    with open(os.path.join(tdir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    steps = [e for e in events if e["kind"] == "scalars"
             and "d_loss" in e["values"]]
    if [e["step"] for e in steps] != list(range(1, MG_SAGAN_STEPS + 1)) \
            or not all(np.isfinite([e["values"][k] for k in (
                "d_loss", "d_loss_real", "d_loss_fake", "g_loss")]).all()
                       for e in steps):
        fail(f"multi_gpu (b): events {[e['values'] for e in steps]}")
    rows = steps[-1]["values"]
    del state
    for e in kernels:
        e.setdefault("launches_by_path", {})["multi_gpu_sagan256_lc"] = \
            launches[e["name"]]
    long = sorted(s for s in shapes if s[0][1] == m.attn_res ** 2)
    if not long:
        fail(f"multi_gpu (b): no attention at S {m.attn_res ** 2}: {shapes}")
    entry = {"train_s": train_s, "steps": MG_SAGAN_STEPS,
             "launches": launches, "attention_shapes": sorted(shapes),
             "cli_peak_allocated": torch.cuda.max_memory_allocated(),
             "last": rows}
    log(f"multi_gpu (b) sagan256-lc: the CLI trained {MG_SAGAN_STEPS} "
        f"steps in {train_s:.1f} s through the world-1 NCCL path (256 px, "
        f"batch {cfg.batch_size}), attention calls {sorted(shapes)}, "
        f"launches {launches}; peak allocated "
        f"{entry['cli_peak_allocated'] / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()

    # kernels 6-8 at the path's S 16384 shape
    (b, s, dk), (_, _, dv), dt_name = long[0][0], long[0][1], long[0][2]
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    q, k, v = (torch.randn((b, s, d), generator=g, device="cuda").to(
        torch.bfloat16) for d in (dk, dk, dv))
    gout = torch.randn((b, s, dv), generator=g, device="cuda")
    scale = dk ** -0.5
    errs, (do, lse, delta) = flash_round(torch, q, k, v, gout, scale,
                                         rows=FLASH_ROWS)
    calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, scale),
             "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                             scale),
             "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                               scale)}
    timed = {}
    for name, fn in calls.items():
        ms, _ = time_ms(torch, fn, 3, warmup=1,
                        label=f"{name} sagan256-lc [{b}, {s}, {dk}, {dv}]")
        bound, kind = flash_bound(name, b, s, dk, dv, 2)
        timed[name] = {"ms": ms, "bound_ms": bound * 1e3, "bound_by": kind,
                       "max_abs_err": errs[name]}
        log(f"multi_gpu (b) {name} at [{b}, {s}, {dk}, {dv}] bf16: "
            f"{ms:.4f} ms per launch vs bound {bound * 1e3:.4f} ms ({kind}); "
            f"max |err| over {FLASH_ROWS} rows {errs[name]:.3g}")
    entry["flash"] = timed
    del q, k, v, gout, do, lse, delta
    torch.cuda.empty_cache()

    # the step through the world-1 runner: captured if it fits
    world = initialize_multihost(device="cuda")
    rcfg = dc.replace(cfg, batch_size=BATCH, seed=SEED)
    par = make_parallel_train(rcfg, world)
    runner = StepRunner(par.fns, seeded_state(torch, par.fns, rcfg), rcfg,
                        torch.device("cuda"))
    draw = par.step_draws(lambda c, st, d: (None, None))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    images = torch.rand((BATCH, 256, 256, 3), generator=gen,
                        device="cuda") * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    z, d = draw(rcfg, 0, torch.device("cuda"))
    runner.step([images], [z], [d], start=0)
    try:
        z, d = draw(rcfg, 1, torch.device("cuda"))
        runner.step([images], [z], [d], start=1)
        captured = True
    except torch.cuda.OutOfMemoryError as err:
        captured = False
        log(f"multi_gpu (b): the sagan256-lc step does not capture: "
            f"{str(err).splitlines()[0][:160]}")
    torch.cuda.synchronize()
    entry["captured"] = captured
    if captured:
        t0 = time.perf_counter()
        for i in range(2, 5):
            z, d = draw(rcfg, i, torch.device("cuda"))
            out = runner.step([images], [z], [d], start=i)
        out.tolist()
        entry["host_ms"] = (time.perf_counter() - t0) * 1e3 / 3
        prof = replay_profile(torch, runner, 1)
        entry.update({k: prof[k] for k in ("busy_ms", "wall_ms",
                                           "idle_share")})
        entry["graph_pool_bytes"] = sum(
            p.pool_bytes for p in runner.programs.values())
    entry["peak_allocated"] = torch.cuda.max_memory_allocated()
    entry["peak_reserved"] = torch.cuda.max_memory_reserved()
    log(f"multi_gpu (b) sagan256-lc step at batch {BATCH}: captured "
        f"{captured}; host {entry.get('host_ms', float('nan')):.3f} ms, "
        f"busy {entry.get('busy_ms', float('nan')):.3f} ms, idle "
        f"{entry.get('idle_share', float('nan')):.3f}; peak allocated "
        f"{entry['peak_allocated'] / 2 ** 30:.2f} GiB, reserved "
        f"{entry['peak_reserved'] / 2 ** 30:.2f} GiB")
    runner.close()
    del runner
    torch.cuda.empty_cache()
    report["sagan256_lc"] = entry


def adam_move(t, b1, b2):
    """The most one Adam update at step t can move a parameter, in units
    of the learning rate: max |m_hat / sqrt(v_hat)| over every gradient
    sequence (Cauchy-Schwarz over the EMA weights; 1 at t = 1, eps
    aside)."""
    a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    v = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return sum(x * x / y for x, y in zip(a, v)) ** 0.5


def mg_dp8_cfg(precision="", shrink=None):
    """lsun64-dp8 on the kernel route (the model flags chip_smoke's
    celeba64 takes), at the preset's global batch; `shrink` ({"batch_size",
    model fields}) cuts it for a rehearsal on the CPU."""
    import dataclasses as dc

    from dcgan_tpu_torch.presets import get_preset

    shrink = dict(shrink or {})
    cfg = get_preset("lsun64-dp8", seed=SEED,
                     batch_size=shrink.pop("batch_size", 64 * 8))
    cfg = dc.replace(cfg, model=dc.replace(cfg.model, use_pallas=True,
                                           pallas_fused=True, **shrink))
    return dc.replace(cfg, precision=precision) if precision else cfg


def mg_dp8_images(torch, cfg, step, device):
    """The global batch of step `step`, the same on every rank."""
    m = cfg.model
    g = torch.Generator(device=device).manual_seed(SEED + 31 + step)
    return torch.rand((cfg.batch_size, m.output_size, m.output_size,
                       m.c_dim), generator=g, device=device) * 2 - 1


def mg_grads_flat(convert, grads):
    return {f"{net}/{k}": v.float().cpu()
            for net in ("gen", "disc")
            for k, v in convert.flatten(grads[net]).items()}


def mg_dp8_rank(world, *, steps, shrink=None):
    """One rank of (c): the gradients at the seeded state in bf16 and f32,
    `steps` eager steps in bf16 (the gspmd draws: the rank's rows of the
    global step draws), the counts of kernels 1-4 over those steps, the
    runner's program under gloo (eager, no graph), and a digest of the
    final state. Rank 0 also returns the gradients and the state."""
    import hashlib

    import torch

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.parallel import collectives
    from dcgan_tpu_torch.parallel.api import make_parallel_train
    from dcgan_tpu_torch.train import trainer
    from dcgan_tpu_torch.train.steps import tree_map
    from dcgan_tpu_torch.train.warmup import StepRunner

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = world.device
    out = {"rank": world.rank}
    grads = {}
    for precision in ("", "f32"):
        cfg = mg_dp8_cfg(precision, shrink)
        par = make_parallel_train(cfg, world)
        state = par.fns.init(seed=SEED, device=dev)
        z, d = par.step_draws(trainer.step_inputs)(cfg, 0, dev)
        g, _ = par.fns.grads(state, par.rows(
            mg_dp8_images(torch, cfg, 0, dev)), z, d)
        grads[precision or "bf16"] = mg_grads_flat(convert, g)
        del state, g
    cfg = mg_dp8_cfg(shrink=shrink)
    par = make_parallel_train(cfg, world)
    state = par.fns.init(seed=SEED, device=dev)
    wrappers = all_wrappers()
    reset_counts(wrappers)
    losses, step_s = [], []
    draws = par.step_draws(trainer.step_inputs)
    for s in range(steps):
        z, d = draws(cfg, s, dev)
        t0 = time.perf_counter()
        state, m = par.fns.train_step(
            state, par.rows(mg_dp8_images(torch, cfg, s, dev)), z, d)
        losses.append({k: float(v) for k, v in m.items()})
        step_s.append(time.perf_counter() - t0)
    out["launches"] = {w: wrappers[w].launches for w in MG_KERNELS}
    flat = convert.flatten(state)
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(flat[k].detach().cpu().reshape(-1).contiguous().view(
            torch.uint8).numpy().tobytes())
    out.update({"digest": digest.hexdigest(), "losses": losses,
                "step_s": step_s, "staged": dict(collectives.STAGED),
                "gloo_cuda": [bool(v) for v in
                              collectives._GLOO_CUDA.values()]})
    if world.rank == 0:
        out["grads"] = grads
        out["state"] = {k: v.float().cpu() for k, v in flat.items()}
    # the gloo step's runner records no graph: after the warm-up (a step
    # of its own, on a copy of the state) its program runs eagerly
    runner = StepRunner(par.fns, tree_map(torch.clone, state),
                        par.local_cfg, dev)
    z, d = draws(cfg, steps, dev)
    runner.step([par.rows(mg_dp8_images(torch, cfg, steps, dev))], [z],
                [d], start=steps)
    runner.capture("train_step")
    prog = runner.programs["train_step"]
    out["capture"] = {"eager": runner.eager,
                      "graph": prog.graph is not None,
                      "program": type(prog).__name__}
    runner.close()
    return out


def mg_dp8(torch, np, report, kernels):
    """(c): lsun64-dp8's 8 ranks over gloo on the one card (NCCL refuses
    two ranks on one device), kernel route, global batch 512, eager: the
    ranks bit for bit equal; the 8-rank gradients and steps against one
    rank on the global batch (TRAIN_GRAD_TOL per dtype on the gradients,
    TRAIN_ROUTE_TOL on the losses, and on the parameters Adam's bound, 2 *
    lr * the sum of `adam_move` over the steps: two runs from one state
    can differ by no more, whatever their gradients, and a bias that
    feeds a BatchNorm, whose true gradient is 0, may reach it)."""
    import dataclasses as dc

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.parallel.api import make_parallel_train
    from dcgan_tpu_torch.parallel.distributed import single_process
    from dcgan_tpu_torch.testing.multihost import run_world
    from dcgan_tpu_torch.train import trainer

    cfg = mg_dp8_cfg()
    n = cfg.mesh.data
    t0 = time.perf_counter()
    outs = run_world("chip_smoke:mg_dp8_rank", n,
                     kwargs={"steps": MG_DP8_STEPS}, backend="gloo",
                     device="cuda:0", timeout=MG_DP8_TIMEOUT)
    world_s = time.perf_counter() - t0
    digests = {o["digest"] for o in outs}
    if len(digests) != 1:
        fail(f"multi_gpu (c): the {n} ranks' states differ: "
             f"{[o['digest'][:12] for o in outs]}")
    for o in outs:
        if not o["capture"]["eager"] or o["capture"]["graph"]:
            fail(f"multi_gpu (c) rank {o['rank']}: the gloo step's runner "
                 f"is not eager: {o['capture']}")
        want = {w: PER_STEP[w] * MG_DP8_STEPS for w in MG_KERNELS}
        if o["launches"] != want:
            fail(f"multi_gpu (c) rank {o['rank']}: kernels 1-4 launched "
                 f"{o['launches']}, expected {want}")
        if o["losses"] != outs[0]["losses"]:
            fail(f"multi_gpu (c): rank {o['rank']}'s losses differ")
    staged = sum(o["staged"]["host"] for o in outs)
    how = ("staged through host memory (gloo refuses CUDA tensors here)"
           if staged else "on the CUDA tensors (gloo takes them)")
    log(f"multi_gpu (c) lsun64-dp8: {n} gloo ranks on one card in "
        f"{world_s:.1f} s, every rank's state bit for bit equal; "
        f"collectives {how}: {staged} staged calls over the ranks; rank 0 "
        f"steps {[round(s * 1e3, 1) for s in outs[0]['step_s']]} ms; the "
        f"runner eager, no graph recorded: {outs[0]['capture']}")

    # one rank on the global batch, the same init, images and draws
    one = single_process("cuda")
    dev = one.device
    gaps = {}
    for precision, dt_name in (("", "bfloat16"), ("f32", "float32")):
        # one rank: the mesh's data axis over the world of one
        pcfg = mg_dp8_cfg(precision)
        pcfg = dc.replace(pcfg, mesh=dc.replace(pcfg.mesh, data=-1))
        par = make_parallel_train(pcfg, one)
        state = par.fns.init(seed=SEED, device=dev)
        z, d = trainer.step_inputs(pcfg, 0, dev)
        g, _ = par.fns.grads(state, mg_dp8_images(torch, pcfg, 0, dev), z,
                             d)
        want = mg_grads_flat(convert, g)
        del state, g
        got = outs[0]["grads"][precision or "bf16"]
        rtol, atol = TRAIN_GRAD_TOL[dt_name]
        worst = {}
        for net in ("gen", "disc"):
            names = [k for k in want if k.startswith(net + "/")]
            top = max(float(want[k].norm()) for k in names)
            for k in names:
                worst[k] = float((got[k] - want[k]).norm()) / (
                    rtol * float(want[k].norm()) + atol * top)
        bad = {k: v for k, v in worst.items() if v > 1.0}
        if bad:
            fail(f"multi_gpu (c) {dt_name}: the 8-rank gradients differ "
                 f"from one rank's on the global batch beyond "
                 f"TRAIN_GRAD_TOL: {bad}")
        gaps[dt_name] = max(worst.values())
        log(f"multi_gpu (c) {dt_name}: the 8-rank gradients at the seeded "
            f"state equal one rank's on the global batch of "
            f"{pcfg.batch_size} within TRAIN_GRAD_TOL {TRAIN_GRAD_TOL[dt_name]}"
            f" (largest gap {gaps[dt_name]:.3g} of 1)")
    pcfg = dc.replace(cfg, mesh=dc.replace(cfg.mesh, data=-1))
    par = make_parallel_train(pcfg, one)
    state = par.fns.init(seed=SEED, device=dev)
    losses = []
    for s in range(MG_DP8_STEPS):
        z, d = trainer.step_inputs(pcfg, s, dev)
        state, m = par.fns.train_step(
            state, mg_dp8_images(torch, pcfg, s, dev), z, d)
        losses.append({k: float(v) for k, v in m.items()})
    rtol, atol = TRAIN_ROUTE_TOL["bfloat16"]
    for got, want in zip(outs[0]["losses"], losses):
        for k, w in want.items():
            if abs(got[k] - w) > rtol * abs(w) + atol:
                fail(f"multi_gpu (c): loss {k} {got[k]} on 8 ranks vs {w} "
                     f"on one")
    # (1 + 1e-5): the f32 rounding of the updates themselves
    bound = 2 * cfg.learning_rate * (1 + 1e-5) * sum(
        adam_move(t, cfg.beta1, 0.999) for t in range(1, MG_DP8_STEPS + 1))
    flat = {k: v.float().cpu() for k, v in convert.flatten(state).items()}
    errs = {k: float((outs[0]["state"][k] - flat[k]).abs().max())
            for k in flat if k.startswith("params/")}
    param_err = max(errs.values())
    worst = max(errs, key=errs.get)
    # the biases that feed a BatchNorm (no true gradient) apart
    rest = max(v for k, v in errs.items()
               if not re.search(r"(proj|deconv[1-9]|conv[1-9])/b$", k))
    if param_err > bound:
        fail(f"multi_gpu (c): the 8-rank parameters are {param_err:.6g} "
             f"from one rank's ({worst}), beyond Adam's bound "
             f"{bound:.6g}")
    log(f"multi_gpu (c): {MG_DP8_STEPS} steps on 8 ranks against one rank "
        f"on the global batch: losses within TRAIN_ROUTE_TOL bfloat16, "
        f"parameters {param_err:.6g} apart at most ({worst}; Adam's bound "
        f"{bound:.6g}), {rest:.6g} but for the biases that feed a "
        f"BatchNorm")
    del state
    report["lsun64_dp8"] = {
        "ranks": n, "world_s": world_s, "staged_host_calls": staged,
        "grad_gap": gaps, "param_err": param_err,
        "param_err_not_pre_bn": rest, "losses_8": outs[0][
            "losses"], "losses_1": losses,
        "rank0_step_ms": [s * 1e3 for s in outs[0]["step_s"]]}
    for e in kernels:
        e.setdefault("launches_by_path", {})["multi_gpu_lsun64_dp8"] = sum(
            o["launches"].get(e["name"], 0) for o in outs)
    torch.cuda.empty_cache()


def multi_gpu_and_check(torch, np, workdir, kernels):
    """Phases (a)-(c) of the `multi_gpu` group. Returns its report."""
    from dcgan_tpu_torch.parallel.distributed import shutdown

    t0 = time.perf_counter()
    report = {}
    try:
        mg_world_one(torch, np, report, kernels)
        t1 = time.perf_counter()
        mg_sagan256(torch, np, workdir, report, kernels)
        t2 = time.perf_counter()
    finally:
        shutdown()
    mg_dp8(torch, np, report, kernels)
    t3 = time.perf_counter()
    report["seconds"] = {"a": t1 - t0, "b": t2 - t1, "c": t3 - t2,
                         "total": t3 - t0}
    log(f"multi_gpu: the group took {t3 - t0:.1f} s (a {t1 - t0:.1f}, b "
        f"{t2 - t1:.1f}, c {t3 - t2:.1f})")
    return report


# ---------------------------------------------------------------------------
# Phase 25 (`spatial`): the spatial mesh and sequence-parallel attention
# ---------------------------------------------------------------------------

# (a) kernels 7 and 8 with f32 gradients from bf16 operands: sagan128's
# attention (S 4096, one rank's hop at sagan256-lc's S 16 384 over four
# ranks too) and the local ring's launch over sagan256-lc's four blocks
SP_F32_SHAPES = {"sagan128 S 4096": (BATCH, 4096, 8, 32),
                 "sagan256-lc S 16384 / 4 (4 blocks)": (4 * BATCH, 4096, 8,
                                                        32)}
# (b) ring x flash over a local ring against flash over the whole sequence:
# (label, (B, S, d_qk, d_v), dtype, ring sizes)
SP_RINGS = [("sagan128", (BATCH, 4096, 8, 32), "bfloat16", (2, 4)),
            ("sagan128", (BATCH, 4096, 8, 32), "float32", (2, 4)),
            ("sagan256-lc", (BATCH, 16384, 8, 32), "bfloat16", (2, 4)),
            ("C 128 heads", (BATCH, 4096, 16, 64), "bfloat16", (2,))]
# (c), (d): the trainer's steps per rank run
SP_STEPS = 3
SP_TIMEOUT = 600.0
# (c), (d): (name, preset argv, ranks, the mesh and strategy flags)
SP_WORLDS = (
    ("sagan128", ["--preset", "sagan128"], 2,
     ["--mesh_model", "2", "--mesh_spatial", "--seq_strategy", "ring"]),
    ("sagan64", ["--preset", "sagan64", "--attn_heads", "2"], 4,
     ["--mesh_data", "2", "--mesh_model", "2", "--mesh_spatial",
      "--seq_strategy", "ulysses"]))
# the flash kernels' wrappers
SP_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# (c), (d): a parameter element whose two applied gradients agree in sign and
# are both above SP_CLEAR_OF_EPS (1000 x Adam's eps) takes Adam's first
# step -lr * g / (|g| + eps) on both sides alike: the two differ by the
# rounding of one f32 update, within SP_PARAM_ATOL
SP_CLEAR_OF_EPS, SP_PARAM_ATOL = 1e-5, 1e-6


def sp_f32_bound(name, b, s, dk, dv):
    """flash_bound for bf16 operands whose gradients are written as f32
    (4 bytes an output element, not 2)."""
    t, by = flash_bound(name, b, s, dk, dv, 2)
    outs = dk if name == "flash_dq" else dk + dv
    bytes_ = 2.0 * b * s * (2 * dk + 2 * dv) + 4.0 * b * s * outs \
        + 8.0 * b * s
    t_bytes = bytes_ / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes > t else (t, by)


def sp_f32_kernels(torch, kernels, report):
    """(a): flash_dq and flash_dkv with out_dtype=float32 on bf16
    operands, launched twice (the same bits), against their plain versions
    over FLASH_ROWS rows of the batch within kernel_error_bounds (no bf16
    rounding of the output), timed beside their bound."""
    from dcgan_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    f32 = torch.float32
    rows = []
    for label, (b, s, dk, dv) in SP_F32_SHAPES.items():
        q, k, v = (torch.randn((b, s, d), generator=g, device=dev)
                   .to(torch.bfloat16) for d in (dk, dk, dv))
        gout = torch.randn((b, s, dv), generator=g, device=dev)
        scale = dk ** -0.5
        out, lse = fa.flash_fwd(q, k, v, scale)
        do, delta = fa.bwd_stats(q, out, gout)
        args = (q, k, v, do, lse, delta, scale)
        dq = fa.flash_dq(*args, out_dtype=f32)
        dkv = fa.flash_dkv(*args, out_dtype=f32)
        again = (fa.flash_dq(*args, out_dtype=f32),
                 *fa.flash_dkv(*args, out_dtype=f32))
        torch.cuda.synchronize()
        same_bits(torch, f"f32-output flash_dq, flash_dkv {label}",
                  (dq, *dkv), again)
        if dq.dtype != f32 or dkv[0].dtype != f32 or dkv[1].dtype != f32:
            fail(f"spatial (a) {label}: the gradients are {dq.dtype}, "
                 f"{dkv[0].dtype}, {dkv[1].dtype}, not float32")
        n = FLASH_ROWS
        sl = [t[:n] for t in (q, k, v, do, lse, delta)]
        bounds = fa.kernel_error_bounds(*sl, scale)
        errs = {"flash_dq": flash_close(
            torch, f"f32-output flash_dq {label}", dq[:n],
            fa.flash_dq_plain(*sl, scale, f32), bounds["dq"])}
        want_dk, want_dv = fa.flash_dkv_plain(*sl, scale, f32)
        errs["flash_dkv"] = max(
            flash_close(torch, f"f32-output flash_dkv dk {label}",
                        dkv[0][:n], want_dk, bounds["dk"]),
            flash_close(torch, f"f32-output flash_dkv dv {label}",
                        dkv[1][:n], want_dv, bounds["dv"]))
        del again, want_dk, want_dv
        calls = {"flash_dq": (lambda: fa.flash_dq(*args, out_dtype=f32),
                              lambda: fa.flash_dq_plain(*sl, scale, f32)),
                 "flash_dkv": (lambda: fa.flash_dkv(*args, out_dtype=f32),
                               lambda: fa.flash_dkv_plain(*sl, scale,
                                                          f32))}
        for name, (kernel, plain) in calls.items():
            ms, call_ms = time_ms(torch, kernel, 5, warmup=1,
                                  label=f"{name} f32 out {label}")
            plain_ms, _ = time_ms(torch, plain, 2, warmup=1,
                                  label=f"{name} f32 out plain {label}")
            bound, by = sp_f32_bound(name, b, s, dk, dv)
            row = {"name": name, "shape": [b, s, dk, dv], "label": label,
                   "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                   "plain_rows": n, "bound_ms": bound * 1e3,
                   "bound_kind": by,
                   "bound_by": "bytes" if by == "bytes" else "operations",
                   "library_ms": None, "max_abs_err": errs[name]}
            rows.append(row)
            for entry in kernels:
                if entry["name"] == name:
                    entry.setdefault("f32_out", []).append(row)
            log(f"spatial (a) {name} f32 out at {label} {[b, s, dk, dv]}: "
                f"{ms:.4f} ms vs bound {bound * 1e3:.4f} ms ({by}); plain "
                f"over {n} rows {plain_ms:.4f} ms; max |err| "
                f"{errs[name]:.3g}")
        del q, k, v, gout, out, lse, do, delta, dq, dkv, args, sl, bounds
        torch.cuda.empty_cache()
    report["f32_out"] = rows


def sp_local_ring(torch, report):
    """(b): ring x flash over a LocalRing of n blocks against flash over
    the whole sequence, forward and backward: n flash_fwd, n flash_dq and
    n flash_dkv launches a round; out, lse, dq, dk and dv over FLASH_ROWS
    rows of the batch within twice kernel_error_bounds (each side's own
    distance to the exact values; bf16 gradients one ulp more each), every
    row finite; both timed."""
    from dcgan_tpu_torch.ops import flash_attention as fa
    from dcgan_tpu_torch.parallel.collectives import LocalRing

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    wrappers = all_wrappers()
    rows = []
    for label, (b, s, dk, dv), dt_name, ns in SP_RINGS:
        dt = getattr(torch, dt_name)
        q, k, v = (torch.randn((b, s, d), generator=g, device=dev).to(dt)
                   for d in (dk, dk, dv))
        gout = torch.randn((b, s, dv), generator=g, device=dev)
        scale = dk ** -0.5

        def whole():
            out, lse = fa.flash_fwd(q, k, v, scale)
            do, delta = fa.bwd_stats(q, out, gout)
            return (out, lse, fa.flash_dq(q, k, v, do, lse, delta, scale),
                    *fa.flash_dkv(q, k, v, do, lse, delta, scale))

        want = whole()
        do, delta = fa.bwd_stats(q, want[0], gout)
        n_rows = FLASH_ROWS
        bounds = fa.kernel_error_bounds(
            *(t[:n_rows] for t in (q, k, v, do, want[1], delta)), scale)
        whole_ms, _ = time_ms(torch, whole, 3, warmup=0,
                              label=f"whole flash {label} {dt_name}")
        for n in ns:
            ring = LocalRing(n)
            stacked = [ring.stack(t) for t in (q, k, v, gout)]

            def ring_round():
                out, lse = fa.ring_flash_forward(*stacked[:3], scale, ring)
                return (out, lse, *fa.ring_flash_backward(
                    *stacked[:3], out, lse, stacked[3], scale, ring))

            reset_counts(wrappers)
            got = [ring.unstack(t) for t in ring_round()]
            torch.cuda.synchronize()
            launches = {w: wrappers[w].launches for w in SP_KERNELS}
            if launches != {w: n for w in SP_KERNELS}:
                fail(f"spatial (b) {label} n={n}: launches {launches}, "
                     f"expected {n} of each")
            tag = f"{label} {[b, s, dk, dv]} {dt_name} n={n}"
            errs = {}
            for name, i, bound in (("out", 0, bounds["out"]),
                                   ("lse", 1, 1e-5 * (1.0 + want[1][
                                       :n_rows].abs())),
                                   ("dq", 2, bounds["dq"]),
                                   ("dk", 3, bounds["dk"]),
                                   ("dv", 4, bounds["dv"])):
                if not bool(torch.isfinite(got[i]).all()):
                    fail(f"spatial (b) {tag}: non-finite {name}")
                if got[i].dtype != want[i].dtype:
                    fail(f"spatial (b) {tag}: {name} is {got[i].dtype}, "
                         f"flash's {want[i].dtype}")
                errs[name] = flash_close(
                    torch, f"spatial (b) ring x flash {name} {tag}",
                    got[i][:n_rows], want[i][:n_rows].to(got[i].dtype),
                    2.0 * bound
                    + (2.0 ** -7 * want[i][:n_rows].float().abs()
                       if got[i].dtype == torch.bfloat16 else 0.0))
            all_rows = {name: float((got[i].float() - want[i].float())
                                    .abs().max())
                        for name, i in (("out", 0), ("dq", 2), ("dk", 3),
                                        ("dv", 4))}
            ms, _ = time_ms(torch, ring_round, 3, warmup=0,
                            label=f"ring x flash {tag}")
            rows.append({"label": label, "shape": [b, s, dk, dv],
                         "dtype": dt_name, "n": n, "launches": launches,
                         "max_abs_err": errs, "max_abs_diff_all_rows":
                         all_rows, "ms": ms, "whole_flash_ms": whole_ms})
            log(f"spatial (b) ring x flash {tag}: {launches} launches; "
                f"max |err| over {n_rows} rows {errs}, over all rows "
                f"{all_rows}; {ms:.3f} ms fwd + bwd against whole-sequence "
                f"flash {whole_ms:.3f} ms")
            del got, stacked
        del q, k, v, gout, want, do, delta, bounds
        torch.cuda.empty_cache()
    report["local_ring"] = rows


def sp_hooked_main(argv):
    """train.cli.main(argv) with the world's train_step timed and its
    metrics read after every step (the readback ends the step on the
    host). Returns (final state, [metrics], [host ms])."""
    import torch

    from dcgan_tpu_torch.train import cli, trainer

    record = {"metrics": [], "ms": []}
    orig = trainer.make_parallel_train

    def hooked(cfg, world):
        par = orig(cfg, world)
        inner = par.fns.train_step

        def timed(state, images, *args, **kwargs):
            t0 = time.perf_counter()
            state, m = inner(state, images, *args, **kwargs)
            record["metrics"].append({k: float(v) for k, v in m.items()})
            record["ms"].append((time.perf_counter() - t0) * 1e3)
            return state, m
        return dataclasses.replace(par, fns=dataclasses.replace(
            par.fns, train_step=timed))

    trainer.make_parallel_train = hooked
    try:
        state = cli.main(argv)
    finally:
        trainer.make_parallel_train = orig
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return state, record["metrics"], record["ms"]


def sp_argv(workdir, name, preset, mesh, *, f32, steps, extra=()):
    """The trainer's flags of a run of (c) or (d); `extra` last (a CPU
    rehearsal's device and sizes)."""
    tag = f"{name}_{'f32' if f32 else 'bf16'}_{'w' if mesh else 'one'}"
    argv = preset + mesh + [
        "--synthetic", "--max_steps", str(steps), "--seed", str(SEED),
        "--device", "cuda", "--checkpoint_dir",
        os.path.join(workdir, "spatial", tag), "--sample_every_steps", "0",
        "--activation_summary_steps", "0"]
    return argv + (["--precision", "f32"] if f32 else []) + list(extra)


def sp_config(preset, mesh, extra, f32):
    """The TrainConfig of a run of (c) or (d), as the trainer's CLI
    builds it."""
    from dcgan_tpu_torch.train import cli

    argv = preset + mesh + ["--seed", str(SEED)] + list(extra) + (
        ["--precision", "f32"] if f32 else [])
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def sp_one_step(torch, cfg, world):
    """One f32 step of `cfg`'s programs on `world` from the seeded init:
    the global batch of SEED + 53 (every rank the same, each taking its
    rows and the programs its rows of the images) and the trainer's draws
    of step 0 (the gspmd rows). Returns (metrics, flat state, launches,
    both nets' gradients at the init against the pre-update D, from
    `fns.grads`, flat as mg_grads_flat)."""
    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.parallel.api import make_parallel_train
    from dcgan_tpu_torch.train import trainer

    dev = world.device
    m = cfg.model
    par = make_parallel_train(cfg, world)
    state = par.fns.init(seed=SEED, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 53)
    images = torch.rand((cfg.batch_size, m.output_size, m.output_size,
                         m.c_dim), generator=g, device=dev) * 2 - 1
    z, draws = par.step_draws(trainer.step_inputs)(cfg, 0, dev)
    grads = mg_grads_flat(convert, par.fns.grads(state, par.rows(images), z,
                                                 draws)[0])
    wrappers = all_wrappers()
    reset_counts(wrappers)
    state, metrics = par.fns.train_step(state, par.rows(images), z, draws)
    metrics = {k: float(v) for k, v in metrics.items()}
    launches = {w: wrappers[w].launches for w in SP_KERNELS}
    flat = {k: v.float().cpu() for k, v in convert.flatten(state).items()}
    return metrics, flat, launches, grads


def sp_digest(torch, flat):
    import hashlib

    digest = hashlib.sha256()
    for key in sorted(flat):
        digest.update(flat[key].detach().cpu().reshape(-1).contiguous()
                      .view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def sp_rank(world, *, workdir, name, preset, mesh, extra=()):
    """One rank of (c) or (d): one f32 step of the world's programs
    (sp_one_step, TF32 off), then SP_STEPS bf16 steps through the trainer
    with the counters set to 0 before and read after: the metrics and
    host ms of every step, the staged and issued collectives, a digest of
    each final state, and on rank 0 the f32 state."""
    import torch

    from dcgan_tpu_torch import convert
    from dcgan_tpu_torch.parallel import collectives

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    metrics, flat, launches, grads = sp_one_step(
        torch, sp_config(preset, mesh, extra, f32=True), world)
    out = {"rank": world.rank, "f32": {
        "metrics": [metrics], "launches": launches,
        "digest": sp_digest(torch, flat)}}
    if world.rank == 0:
        out["f32"]["state"], out["f32"]["grads"] = flat, grads
    del flat, grads
    wrappers = all_wrappers()
    reset_counts(wrappers)
    before = dict(collectives.COUNTS)
    staged = collectives.STAGED["host"]
    t0 = time.perf_counter()
    state, metrics, ms = sp_hooked_main(sp_argv(
        workdir, name, preset, mesh, f32=False, steps=SP_STEPS,
        extra=extra))
    out["bf16"] = {
        "train_s": time.perf_counter() - t0, "metrics": metrics,
        "host_ms": ms,
        "launches": {w: wrappers[w].launches for w in SP_KERNELS},
        "collectives": {k: collectives.COUNTS[k] - before[k]
                        for k in collectives.COUNTS},
        "staged": collectives.STAGED["host"] - staged,
        "digest": sp_digest(torch, convert.flatten(state))}
    out["gloo_cuda"] = {kind: bool(v) for (_, kind), v in
                        collectives._GLOO_CUDA.items()}
    return out


def sp_hold_step(name, cfg, got, want, want_grads):
    """The f32 step of rank 0 of the world (`got`: its flat "state" and
    "grads") against world 1's (`want`, `want_grads`), from one init.
    The gradients: both nets' at the init, G's against the pre-update D
    (`fns.grads`), every leaf within TRAIN_GRAD_TOL float32 (rtol on the
    leaf's norm, atol times the net's largest leaf norm). The parameters:
    Adam's first step moves each by lr * g / (|g| + eps), about lr whatever
    the size of g, so they are held element by element against the
    gradient each side applied, its Adam mu (beta1 is 0): within
    SP_PARAM_ATOL where the two agree in sign clear of Adam's eps,
    everywhere within 2 * lr + 1e-5 (a gradient zero to rounding whose
    sign differs moves it 2 * lr apart). The sequential step takes G's
    gradient at the updated D, whose first step turns D's rounding into
    moves of 2 * lr, so the applied G gradients are compared by the
    parameter rule only. Returns the gaps (in units of the limit for the
    gradients), and the leaves with elements that flipped, each with the
    largest |applied gradient| at a flipped element over the leaf's
    largest and the leaf's norm over the net's largest (a bias that feeds
    a BatchNorm has no true gradient: all of it is rounding)."""
    if cfg.beta1 != 0.0:
        fail(f"spatial {name}: the parameter rule reads Adam's mu as the "
             f"applied gradient, which needs beta1 = 0, not {cfg.beta1}")
    lr = {"gen": cfg.g_learning_rate or cfg.learning_rate,
          "disc": cfg.d_learning_rate or cfg.learning_rate}
    rtol, atol = TRAIN_GRAD_TOL["float32"]
    grad_gap, param_err, wide_err, flipped = {}, {}, {}, {}
    for net in ("gen", "disc"):
        names = [k for k in want_grads if k.startswith(net + "/")]
        top = max(float(want_grads[k].norm()) for k in names)
        for key in names:
            w = want_grads[key]
            gap = float((got["grads"][key] - w).norm()) / (
                rtol * float(w.norm()) + atol * top)
            if gap > 1.0:
                fail(f"spatial {name}: the gradient {key} at the init is "
                     f"{gap:.3g} x TRAIN_GRAD_TOL float32 from world 1's")
            grad_gap[net] = max(grad_gap.get(net, 0.0), gap)
        head = f"opt/{net}/mu/"
        mus = [k for k in want if k.startswith(head)]
        top = max(float(want[k].norm()) for k in mus)
        for key in mus:
            g, w = got["state"][key], want[key]
            param = f"params/{net}/" + key[len(head):]
            diff = (got["state"][param] - want[param]).abs()
            agree = (g.sign() == w.sign()) & (g.abs() > SP_CLEAR_OF_EPS) \
                & (w.abs() > SP_CLEAR_OF_EPS)
            close = float(diff[agree].max()) if agree.any() else 0.0
            wide = float(diff.max())
            if close > SP_PARAM_ATOL or wide > 2 * lr[net] + 1e-5:
                fail(f"spatial {name}: {param} off world 1's by {close} "
                     f"where the applied gradients agree (SP_PARAM_ATOL "
                     f"{SP_PARAM_ATOL}), {wide} anywhere (2 * lr + 1e-5 = "
                     f"{2 * lr[net] + 1e-5})")
            param_err[net] = max(param_err.get(net, 0.0), close)
            wide_err[net] = max(wide_err.get(net, 0.0), wide)
            flips = g.sign() != w.sign()
            if flips.any():
                flipped[param] = {
                    "elements": int(flips.sum()), "of": w.numel(),
                    "max_applied_grad_over_leaf_max": float(
                        w.abs()[flips].max() / w.abs().max()),
                    "leaf_norm_over_net_top": float(w.norm()) / top}
    return {"grad_gap": grad_gap, "param_err": param_err,
            "param_err_any": wide_err, "flipped": flipped}


def sp_world(torch, workdir, kernels, report, name, preset, n, mesh,
             extra=(), device="cuda:0"):
    """(c) or (d): `n` gloo ranks sharing the card (sp_rank), against one
    f32 step of the world of one on the same seeded init, global batch and
    draws: every rank's metrics and states the same; the f32 step's losses
    within 1e-4 relative of world 1's, its gradients and parameters by
    sp_hold_step; kernels 6-8 in the f32 step at world 1's launches times
    the ring's size (ring) or equal to them (Ulysses), and launched on
    every rank by the trainer's bf16 steps."""
    from dcgan_tpu_torch.parallel.distributed import single_process
    from dcgan_tpu_torch.testing.multihost import run_world

    cfg = sp_config(preset, [], extra, f32=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    one_metrics, one, one_launches, one_grads = sp_one_step(
        torch, cfg, single_process(device))
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    outs = run_world("chip_smoke:sp_rank", n, kwargs={
        "workdir": workdir, "name": name, "preset": preset, "mesh": mesh,
        "extra": list(extra)}, backend="gloo", device=device,
        timeout=SP_TIMEOUT)
    world_s = time.perf_counter() - t0
    ring = "ring" in mesh
    model = int(mesh[mesh.index("--mesh_model") + 1])
    for run in ("f32", "bf16"):
        if len({o[run]["digest"] for o in outs}) != 1:
            fail(f"spatial {name} {run}: the ranks' states differ")
        for o in outs:
            if o[run]["metrics"] != outs[0][run]["metrics"]:
                fail(f"spatial {name} {run}: rank {o['rank']}'s losses "
                     f"{o[run]['metrics']} differ from rank 0's "
                     f"{outs[0][run]['metrics']}")
            if not all(o[run]["launches"][w] > 0 for w in SP_KERNELS):
                fail(f"spatial {name} {run} rank {o['rank']}: kernels 6-8 "
                     f"launched {o[run]['launches']}")
    want = {w: c * (model if ring else 1) for w, c in one_launches.items()}
    for o in outs:
        if o["f32"]["launches"] != want:
            fail(f"spatial {name}: rank {o['rank']}'s f32 step launched "
                 f"{o['f32']['launches']}, expected {want} (world 1's "
                 f"{one_launches}{f' x {model}' if ring else ''})")
    got_m = outs[0]["f32"]["metrics"][0]
    for key, w in one_metrics.items():
        if abs(got_m[key] - w) > 1e-4 * abs(w):
            fail(f"spatial {name}: the f32 step's {key} {got_m[key]} vs "
                 f"world 1's {w}, beyond 1e-4 relative")
    held = sp_hold_step(name, cfg, outs[0]["f32"], one, one_grads)
    launches = {w: sum(o["bf16"]["launches"][w] for o in outs)
                for w in SP_KERNELS}
    for entry in kernels:
        if entry["name"] in launches:
            entry.setdefault("launches_by_path", {})[f"spatial {name}"] = \
                launches[entry["name"]]
    host_ms = [o["bf16"]["host_ms"] for o in outs]
    report[name] = {
        "ranks": n, "mesh": mesh, "world_s": world_s,
        "metrics_f32": got_m, "metrics_world1": one_metrics, **held,
        "launches_world1_f32": one_launches,
        "launches_f32_rank": outs[0]["f32"]["launches"],
        "launches_bf16": launches,
        "collectives_bf16_rank0": outs[0]["bf16"]["collectives"],
        "staged_bf16": [o["bf16"]["staged"] for o in outs],
        "gloo_cuda": outs[0]["gloo_cuda"], "host_ms_bf16": host_ms,
        "train_s_bf16": [o["bf16"]["train_s"] for o in outs],
        "losses_bf16": outs[0]["bf16"]["metrics"]}
    log(f"spatial {name}: {n} gloo ranks on one card ({' '.join(mesh)}) "
        f"in {world_s:.1f} s; losses equal on every rank; the f32 step "
        f"{got_m} vs world 1's {one_metrics}; gradients within "
        f"{held['grad_gap']} of TRAIN_GRAD_TOL float32; params within "
        f"{held['param_err']} where the gradients agree, "
        f"{held['param_err_any']} anywhere; sign flips "
        f"{held['flipped']}; "
        f"kernels 6-8 {launches} over {SP_STEPS} bf16 trainer steps on the "
        f"ranks; staged {report[name]['staged_bf16']} calls, gloo on CUDA "
        f"{outs[0]['gloo_cuda']}; rank 0 host ms a bf16 step "
        f"{[round(x, 1) for x in host_ms[0]]}")


def spatial_and_check(torch, np, workdir, kernels):
    """Phase 25 (`spatial`): (a) the f32-output kernels 7 and 8, (b) ring
    x flash over a local ring at full size, (c) sagan128 on a 2-rank
    spatial mesh with the ring, (d) sagan64 on a 2 x 2 mesh with Ulysses.
    Returns the group's report."""
    report = {}
    t0 = time.perf_counter()
    sp_f32_kernels(torch, kernels, report)
    t1 = time.perf_counter()
    sp_local_ring(torch, report)
    t2 = time.perf_counter()
    secs = {"a": t1 - t0, "b": t2 - t1}
    for part, (name, preset, n, mesh) in zip("cd", SP_WORLDS):
        t = time.perf_counter()
        sp_world(torch, workdir, kernels, report, name, preset, n, mesh)
        secs[part] = time.perf_counter() - t
    secs["total"] = time.perf_counter() - t0
    report["seconds"] = secs
    log(f"spatial: the group took {secs['total']:.1f} s "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()
                    if k != "total"))
    return report


# the end of the last group (phase_memory logs each group's seconds)
_PHASE_T = time.perf_counter()


def phase_memory(torch, phase, report):
    """A phase's end: its peak device memory, then the garbage collected
    (a captured program's closure refers to its owner, which holds the
    program: a cycle) and the cache emptied. Fails if a CUDA graph's
    private pool is still reserved: the phases after it would run short of
    the card's memory. Adds {peak, left allocated and reserved bytes} to
    `report[phase]` and resets the peaks."""
    global _PHASE_T
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    now = time.perf_counter()
    log(f"{phase}: the group took {now - _PHASE_T:.1f} s")
    _PHASE_T = now
    pooled = [seg for seg in torch.cuda.memory_snapshot()
              if tuple(seg["segment_pool_id"]) != (0, 0)]
    entry = report[phase] = {
        "peak_allocated": torch.cuda.max_memory_allocated(),
        "peak_reserved": torch.cuda.max_memory_reserved(),
        "allocated": torch.cuda.memory_allocated(),
        "reserved": torch.cuda.memory_reserved(),
        "graph_pool_bytes": sum(seg["total_size"] for seg in pooled)}
    log(f"memory after {phase}: " + ", ".join(
        f"{k} {v / 2 ** 30:.2f} GiB" for k, v in entry.items()))
    if pooled:
        fail(f"after {phase}: {len(pooled)} segments of CUDA graph pools "
             f"({entry['graph_pool_bytes']} bytes) still reserved")
    torch.cuda.reset_peak_memory_stats()


def check_sass(_build, libs):
    """Phase 1: the Hopper instructions of HOPPER_SASS in each redesigned
    kernel's entries; fails where an entry lacks one. Returns
    {library: {demangled entry: {opcode: count}}}."""
    found = {}
    for lib_name, checks in HOPPER_SASS.items():
        text = _build.sass(libs[lib_name])
        for part, opcodes in checks:
            counts = _build.sass_counts(text, opcodes)
            entries = {e: c for e, c in counts.items() if part in e}
            if not entries:
                fail(f"no {part} entry in the SASS of {lib_name}")
            names = _build.demangle(list(entries))
            for name, c in zip(names, entries.values()):
                log(f"sass {lib_name} {name}: {c}")
                missing = [op for op in opcodes if c[op] < 1]
                if missing:
                    fail(f"{name} holds no {missing} instruction")
                found.setdefault(lib_name, {}).setdefault(name, {}).update(c)
    return found


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from dcgan_tpu_torch.config import celeba64
    from dcgan_tpu_torch.ops import _build

    # every float32 comparison below runs without TF32 (cuDNN defaults to
    # it for convolutions; matmul is already full f32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")
    torch.cuda.set_device(0)

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    ptxas = []
    for name, lib in sorted(libs.items()):
        report = _build.ptxas_report(
            lib.with_name(lib.name + ".log").read_text())
        names = _build.demangle([e["entry"] for e in report])
        for e, entry in zip(report, names):
            log(f"ptxas {name} {entry}: {e.get('registers')} "
                f"registers, {e.get('stack')} B stack, "
                f"{e.get('spill_stores')} B spill stores, "
                f"{e.get('spill_loads')} B spill loads")
        ptxas += report
    for e in ptxas:
        spilled = e.get("spill_stores", 0) + e.get("spill_loads", 0)
        if spilled and any(part in e["entry"] for part in NO_SPILLS):
            fail(f"{e['entry']} spills {spilled} bytes")
    sass = check_sass(_build, libs)

    cfg = celeba64(use_pallas=True, pallas_fused=True)
    memory = {}
    kernels = check_kernels(torch, cfg, ptxas)
    kernels[1:1] = check_train_kernels(torch, cfg, kernels[0], ptxas)
    kernels += check_flash_kernels(torch, ptxas)
    phase_memory(torch, "kernel checks", memory)
    for entry in kernels:
        if entry["name"] in sass:
            entry["sass"] = sass[entry["name"]]
        elif entry["name"] == "flash_dq":
            entry["sass"] = sass["flash_attention"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        row, timing = serve_and_check(torch, np, cfg, workdir, kernels)
        phase_memory(torch, "serve", memory)
        train_report = train_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "train", memory)
        sagan_report, state, sagan_cfg = sagan_train_and_check(
            torch, np, workdir, kernels)
        sagan_row, sagan_timing = sagan_serve_and_check(
            torch, np, sagan_cfg, state, workdir, kernels)
        del state
        phase_memory(torch, "sagan64", memory)
        resume_report = resume_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "resume", memory)
        capture_report = capture_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "capture", memory)
        a1_report = a1_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "a1", memory)
        memory["a1"]["fp8_128px_pool_bytes"] = sum(
            a1_report["timed"]["kernel_fp8_128px_pool_bytes"].values())
        log(f"memory: the a1 group's fp8 step at 128 px holds "
            f"{memory['a1']['fp8_128px_pool_bytes'] / 2 ** 30:.2f} GiB of "
            f"graph pool; the group peaks at "
            f"{memory['a1']['peak_reserved'] / 2 ** 30:.2f} GiB reserved")
        feed_report = feed_pipeline_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "feed_pipeline", memory)
        fleet_report = serve_fleet_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "serve_fleet", memory)
        cond_report = conditional_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "conditional", memory)
        evals_report = evals_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "evals", memory)
        prog_report = progressive_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "progressive", memory)
        fam_report = families_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "families", memory)
        faults_report = faults_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "faults", memory)
        trace_report = trace_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "trace", memory)
        mg_report = multi_gpu_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "multi_gpu", memory)
        sp_report = spatial_and_check(torch, np, workdir, kernels)
        phase_memory(torch, "spatial", memory)
    print(json.dumps(row), flush=True)
    print(json.dumps({"sampler": timing}), flush=True)
    print(json.dumps({"train": train_report}), flush=True)
    print(json.dumps(sagan_row), flush=True)
    print(json.dumps({"sagan64_sampler": sagan_timing}), flush=True)
    print(json.dumps({"sagan64_train": sagan_report}), flush=True)
    print(json.dumps({"resume": resume_report}), flush=True)
    print(json.dumps({"capture": capture_report}), flush=True)
    print(json.dumps({"a1": a1_report}), flush=True)
    print(json.dumps({"feed_pipeline": feed_report}), flush=True)
    print(json.dumps({"serve_fleet": fleet_report}), flush=True)
    print(json.dumps({"conditional": cond_report}), flush=True)
    print(json.dumps({"evals": evals_report}), flush=True)
    print(json.dumps({"progressive": prog_report}), flush=True)
    print(json.dumps({"families": fam_report}), flush=True)
    print(json.dumps({"faults": faults_report}), flush=True)
    print(json.dumps({"trace": trace_report}), flush=True)
    print(json.dumps({"multi_gpu": mg_report}, default=str), flush=True)
    print(json.dumps({"spatial": sp_report}, default=str), flush=True)
    print(json.dumps({"memory": memory}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    main_run = prog_report["main"]
    print(json.dumps({"progressive_timing": {
        "step_ms_p50": main_run["step_ms_p50"],
        "switch_ms": main_run["switch_ms"],
        "pool_bytes": main_run["pool_bytes"],
        "peak_reserved": memory["progressive"]["peak_reserved"],
        "card": card}}), flush=True)
    print(json.dumps({"families_timing": {
        name: {k: fam_report[name][k] for k in ("step_ms", "busy_ms",
                                                "idle_share")}
        for name in ("sngan_cifar10_step", "stylegan64_step")} | {
        "seconds": fam_report["seconds"],
        "peak_reserved": memory["families"]["peak_reserved"],
        "card": card}}), flush=True)
    print(json.dumps({"faults_timing": {
        **{f"k{k}": {name: faults_report[f"restore_k{k}"][name] for name in (
            "snapshot_device_ms", "snapshot_host_ms", "restore_device_ms",
            "restore_host_ms", "rollback_to_next_replay_ms", "state_bytes")}
           for k in (1, CAPTURE_K)},
        "fed_k1_step": {name: {key: faults_report[f"services_{name}"][key]
                               for key in ("step_ms_p50", "step_ms_mean",
                                           "host_ms_mean", "busy_ms",
                                           "idle_share")}
                        for name in ("async", "inline")},
        "seconds": faults_report["seconds"],
        "peak_reserved": memory["faults"]["peak_reserved"],
        "card": card}}), flush=True)
    print(json.dumps({"trace_timing": {
        "windows": [{k: w[k] for k in ("run", "open", "start", "stop",
                                       "stop_ms", "trace_bytes",
                                       "digest_s")}
                    for w in trace_report["windows"]],
        "rows": [{k.rsplit("/", 1)[1]: v for k, v in r.items()}
                 for r in trace_report["rows"] + [trace_report["pipe_row"]]],
        "step_ms_p50_in_windows": trace_report["step_ms_p50_in_windows"],
        "step_ms_p50_outside": trace_report["step_ms_p50_outside"],
        "busy_ms": trace_report["busy_ms"],
        "seconds": trace_report["seconds"], "card": card}}), flush=True)
    a, b = mg_report["celeba64_world1"], mg_report["sagan256_lc"]
    print(json.dumps({"multi_gpu_timing": {
        "celeba64_world1": {f"k{k}": {key: a[f"k{k}"][key] for key in (
            "nccl_kernels_per_replay", "nccl_ms_per_replay", "nccl_busy_ms",
            "nccl_wall_ms", "nccl_idle_share", "plain_busy_ms",
            "plain_wall_ms", "plain_idle_share")} for k in (1, CAPTURE_K)},
        "sagan256_lc": {key: b.get(key) for key in (
            "captured", "host_ms", "busy_ms", "wall_ms", "idle_share",
            "peak_allocated", "peak_reserved", "graph_pool_bytes",
            "train_s", "flash")},
        "lsun64_dp8": {key: mg_report["lsun64_dp8"][key] for key in (
            "world_s", "staged_host_calls", "grad_gap", "param_err",
            "rank0_step_ms")},
        "seconds": mg_report["seconds"], "card": card}}), flush=True)
    print(json.dumps({"spatial_timing": {
        "f32_out": [{k: r[k] for k in ("name", "shape", "ms", "bound_ms",
                                       "plain_ms")}
                    for r in sp_report["f32_out"]],
        "local_ring": [{k: r[k] for k in ("label", "dtype", "n", "ms",
                                          "whole_flash_ms")}
                       for r in sp_report["local_ring"]],
        **{name: {k: sp_report[name][k] for k in (
            "world_s", "staged_bf16", "host_ms_bf16", "launches_bf16",
            "grad_gap", "param_err", "param_err_any")}
           for name, *_ in SP_WORLDS},
        "seconds": sp_report["seconds"],
        "peak_reserved": memory["spatial"]["peak_reserved"],
        "card": card}}), flush=True)
    print(card, flush=True)
    for entry in kernels:
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["kernel_ms"] = entry["ms"]
        entry["bound_us"] = entry["bound_ms"] * 1e3
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
