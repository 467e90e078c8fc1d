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
   share with the TFRecord feed against the synthetic feed, in turns.

Stdout ends with the serve reports, the sampler timing, the train
reports, the resume report, the card's name and power limit (nvidia-smi),
one JSON line
{"kernels": [...]} and, last, one JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero, printing no result, when no GPU is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
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


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
        gemm_bias_moments_plain, gemm_plan, w_to_gemm
    from dcgan_tpu_torch.ops.kernels import channel_moments, \
        channel_moments_plain, moments_plan, scale_shift_act, \
        scale_shift_act_bwd, scale_shift_act_bwd_plain, \
        scale_shift_act_plain, sm_count

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
    k1_designs = channel_moments.launches_by_design
    sms = sm_count(dev)
    # (name, N, C, launches per step on the main path, on the use_pallas
    # route without pallas_fused: every BN's moments, G forwarding twice
    # and D three times per step); bn0 and D conv3 share [1024, 512]
    moment_shapes = [("G bn0", n0, top, 2, 2)] + [
        (s["name"], s["m"], s["c"], 0, s["fwd"]) for s in stages]

    def check_moments(tag, x):
        """Kernel 1 launched twice on the plan moments_plan makes: that
        design taken, the same bits twice, the plain version matched as
        column sums. Returns (max |err|, the plan)."""
        plan = moments_plan(*x.shape, x.dtype, x.data_ptr() % 16 == 0, sms)
        before = dict(k1_designs)
        got, again = channel_moments(x), channel_moments(x)
        want = channel_moments_plain(x)
        torch.cuda.synchronize()
        if k1_designs != dict(before, **{plan.design:
                                         before[plan.design] + 2}):
            fail(f"channel_moments {tag} did not take design {plan.design}: "
                 f"{before} -> {k1_designs}")
        same_bits(torch, f"channel_moments {tag}", got, again)
        xf = x.float()
        return max(column_sum_close(
            torch, f"channel_moments {tag} {i}", a, w, t)
            for i, (a, w, t) in enumerate(zip(
                got, want, (xf.abs().mean(0), (xf * xf).mean(0))))), plan

    # ragged shapes on the scalar design, and bn0 one element off 16-byte
    # alignment
    for dt_name, dt in dtypes:
        for shape, offset in (((37, 70), 0), ((5, 3), 0), ((n0, top), 1)):
            x = at_offset(torch, rand(*shape, lo=-2.0, hi=2.0).to(dt),
                          offset)
            _, plan = check_moments(f"{dt_name} {shape} +{offset}", x)
            if plan.design != "scalar":
                fail(f"channel_moments {shape} +{offset} plans {plan}")
    log("channel_moments ragged and unaligned shapes match their plain "
        "versions and repeat bitwise on the scalar design")
    errs = {}
    timed = {}
    for name, n, c, per_step, per_step_unfused in moment_shapes:
        for dt_name, dt in dtypes:
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            err, plan = check_moments(f"{name} {dt_name}", x)
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
    k3_designs = scale_shift_act_bwd.launches_by_design
    epilogues = [("G bn0", n0, top, "relu", 2, 1)] + [
        (s["name"], s["m"], s["c"], s["act"], s["fwd"], s["bwd"])
        for s in stages]

    def check_ssa_bwd(tag, x, gr, scale, shift, act, design):
        """Kernel 3 launched twice on the design ssa_bwd_design picks:
        that design taken, the same bits twice, and the plain version
        matched (dx elementwise, dscale and dshift as column sums)."""
        before = dict(k3_designs)
        got = scale_shift_act_bwd(x, scale, shift, gr, act)
        again = scale_shift_act_bwd(x, scale, shift, gr, act)
        want = scale_shift_act_bwd_plain(x, scale, shift, gr, act)
        torch.cuda.synchronize()
        if k3_designs != dict(before, **{design: before[design] + 2}):
            fail(f"scale_shift_act_bwd {tag} did not take design {design}: "
                 f"{before} -> {k3_designs}")
        same_bits(torch, f"scale_shift_act_bwd {tag}", got, again)
        dt_name = "bfloat16" if x.dtype is torch.bfloat16 else "float32"
        ga, xa = gr.float().abs(), x.float().abs()
        return max(check_close(torch, f"scale_shift_act_bwd {tag} dx",
                               got[0], want[0], dt_name),
                   column_sum_close(torch, f"scale_shift_act_bwd {tag} "
                                    f"dscale", got[1], want[1],
                                    (ga * xa).sum(0)),
                   column_sum_close(torch, f"scale_shift_act_bwd {tag} "
                                    f"dshift", got[2], want[2], ga.sum(0)))

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
                check_ssa_bwd(f"ragged {dt_name} [37, {c}] +{offset} {act}",
                              x, gr, scale, shift, act, design)
    log("scale_shift_act_bwd ragged shapes match their plain versions and "
        "repeat bitwise on designs scalar (C 70; C 72 off 16-byte "
        "alignment) and vector (C 72), every act, bf16 and f32")
    fwd_shapes = []
    errs = {}
    k2_designs = scale_shift_act.launches_by_design
    for name, n, c, act, fwd, bwd in epilogues:
        for dt_name, dt in dtypes:
            x = rand(n, c, lo=-2.0, hi=2.0).to(dt)
            gr = rand(n, c).to(dt)
            scale, shift = rand(c, lo=0.5, hi=1.5), rand(c, lo=-0.5, hi=0.5)
            err = check_ssa_bwd(f"{name} {dt_name}", x, gr, scale, shift,
                                act, k3["design"])
            errs[dt_name] = max(errs.get(dt_name, 0.0), err)
            # kernel 2 at this epilogue's shape, every act, on its design
            k2_err = 0.0
            for a in ACTS:
                before = dict(k2_designs)
                y = scale_shift_act(x, scale, shift, a)
                torch.cuda.synchronize()
                design = TRAIN_DESIGN["scale_shift_act"]
                if k2_designs != dict(before, **{design: before[design] + 1}):
                    fail(f"scale_shift_act {name} {dt_name} {a} did not take "
                         f"design {design}: {before} -> {k2_designs}")
                k2_err = max(k2_err, check_close(
                    torch, f"scale_shift_act {name} {dt_name} {a}", y,
                    scale_shift_act_plain(x, scale, shift, a), dt_name))
            key = "max_abs_err" if dt is torch.bfloat16 \
                else "max_abs_err_f32"
            ssa_entry[key] = max(ssa_entry[key], k2_err)
            log(f"scale_shift_act {name} [{n}, {c}] {dt_name} takes design "
                f"{design} and matches its plain version at every act (max "
                f"|err| {k2_err:.3g})")
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
    k4_designs = gemm_bias_moments.launches_by_design

    def check_gbm(tag, p2d, w2d, b, dt):
        """Kernel 4 launched twice on the design its plan (gemm_plan) picks:
        that design taken, the same bits twice, u against the plain product
        (f32 tolerance: u is f32 in both dtypes) and the moments against
        those of the kernel's own u in the compute dtype (column sums: only
        the summation order differs). Returns (max |err|, the plan)."""
        plan = gemm_plan(p2d, w2d, sms)
        before = dict(k4_designs)
        got = gemm_bias_moments(p2d, w2d, b, dt)
        again = gemm_bias_moments(p2d, w2d, b, dt)
        u_want = gemm_bias_moments_plain(p2d, w2d, b, dt)[0]
        torch.cuda.synchronize()
        if k4_designs != dict(before, **{plan.design:
                                         before[plan.design] + 2}):
            fail(f"gemm_bias_moments {tag} did not take its plan's design "
                 f"{plan.design}: {before} -> {k4_designs}")
        same_bits(torch, f"gemm_bias_moments {tag}", got, again)
        err = check_close(torch, f"gemm_bias_moments {tag} u", got[0],
                          u_want, "float32")
        v = got[0].to(dt).float()
        err = max(err, column_sum_close(
            torch, f"gemm_bias_moments {tag} mean", got[1], v.mean(0),
            v.abs().mean(0)), column_sum_close(
            torch, f"gemm_bias_moments {tag} mean_sq", got[2],
            (v * v).mean(0), (v * v).mean(0)))
        return err, plan

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
        _, plan = check_gbm(tag, p, w, b, dt)
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
            # operands as the step builds them: post-activation maps
            # through the (dilated) im2col, HWIO weights reshaped
            h = act_fwd(rand(BATCH, st["res"], st["res"], st["in_ch"]),
                        st["act"], cfg.leak).to(dt)
            p2d, _ = conv_patches(h, cfg.kernel_size, 2, st["transpose"])
            w2d = w_to_gemm(0.02 * torch.randn(
                (cfg.kernel_size, cfg.kernel_size, st["in_ch"], c),
                generator=g, device=dev)).to(dt)
            b = rand(c, lo=-0.1, hi=0.1)
            if tuple(p2d.shape) != (m, k):
                fail(f"{name}: patches {tuple(p2d.shape)} != {(m, k)}")
            err, plan = check_gbm(f"{name} {dt_name}", p2d, w2d, b, dt)
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
    row, responses = serve_main.run([
        "--weights", path, "--device", "cuda", "--max_batch", str(BATCH),
        "--demo_requests", str(N_REQUESTS), "--demo_rps", "500",
        "--demo_max_images", "8", "--seed", str(SEED),
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
    from dcgan_tpu_torch.ops.flash_attention import flash_dkv, flash_dq, \
        flash_fwd
    from dcgan_tpu_torch.ops.fused import gemm_bias_moments, \
        gemm_bias_scale_act
    from dcgan_tpu_torch.ops.kernels import channel_moments, \
        scale_shift_act, scale_shift_act_bwd

    return {"channel_moments": channel_moments,
            "scale_shift_act": scale_shift_act,
            "scale_shift_act_bwd": scale_shift_act_bwd,
            "gemm_bias_moments": gemm_bias_moments,
            "gemm_bias_scale_act": gemm_bias_scale_act,
            "flash_fwd": flash_fwd, "flash_dq": flash_dq,
            "flash_dkv": flash_dkv}


def profile_split(torch, fn, steps: int = 3):
    """Device time of `steps` calls of fn() by kernel family, from
    torch.profiler's per-kernel self device times, and the share of the
    window the card sat idle. None if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type.name != "CUDA":
            continue
        ms = us / 1e3 / steps
        top.append((ms, e.count / steps, e.key[:120]))
        key = e.key.lower()
        m = re.search(r"flash_\w+_kernel(<[^>]*>)?", e.key)
        if m:
            f = flash.setdefault(m.group(0), {"ms": 0.0, "calls": 0.0})
            f["ms"] += ms
            f["calls"] += e.count / steps
        for name, marks in families.items():
            if any(mark in key for mark in marks):
                split[name] += ms
                if name == "port kernels":
                    # the entry's name without namespace or parameters
                    m = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
                    f = port.setdefault(m.group(0)[:-1] if m else e.key,
                                        {"ms": 0.0, "calls": 0.0})
                    f["ms"] += ms
                    f["calls"] += e.count / steps
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
# (flash_fwd_kernel<16, 32>, flash_dq_kernel<16, 32>,
# flash_dkv_kernel<16, 32>)
FLASH_ENTRIES = {"flash_fwd": "16flash_fwd_kernelILi16ELi32E",
                 "flash_dq": "15flash_dq_kernelILi16ELi32E",
                 "flash_dkv": "16flash_dkv_kernelILi16ELi32E"}


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
    row, responses = serve_main.run([
        "--weights", path, "--device", "cuda", "--max_batch", str(BATCH),
        "--demo_requests", str(N_REQUESTS), "--demo_rps", "500",
        "--demo_max_images", "8", "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for entry in kernels:
        entry.setdefault("launches_by_path", {})["sagan64 serve"] = \
            launches[entry["name"]]
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


def loader_rate(cfg):
    """(first batch s, images/s after it) of the Python loader on the
    phase's shards, on the host alone."""
    from dcgan_tpu_torch.data.pipeline import PythonLoader, list_shards

    mcfg = cfg.model
    loader = PythonLoader(
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
    two warm steps; and the profiled idle share of such steps."""
    dev = torch.device("cuda", torch.cuda.current_device())
    data = trainer.make_data(cfg, dev, synthetic_data=synthetic)
    z = trainer.step_z(cfg, 0, dev)

    def step():
        return fns.train_step(state, next(data), z)[1]["d_loss"].item()

    try:
        for _ in range(2):
            step()
        t0 = time.perf_counter()
        for _ in range(FEED_STEPS):
            step()
        ms = (time.perf_counter() - t0) * 1e3 / FEED_STEPS
        split = profile_split(torch, step, steps=FEED_STEPS)
    finally:
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
    row, responses = serve_main.run([
        "--checkpoint_dir", run, "--device", "cuda", "--max_batch",
        str(BATCH), "--demo_requests", str(RESUME_REQUESTS), "--demo_rps",
        "500", "--demo_max_images", "8", "--seed", str(SEED)])
    torch.cuda.synchronize()
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
    z = trainer.step_z(cfg, RESUME_STEPS, dev)
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
    report["launches"] = launches
    return report


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
    kernels = check_kernels(torch, cfg, ptxas)
    kernels[1:1] = check_train_kernels(torch, cfg, kernels[0], ptxas)
    kernels += check_flash_kernels(torch, ptxas)
    for entry in kernels:
        if entry["name"] in sass:
            entry["sass"] = sass[entry["name"]]
        elif entry["name"] == "flash_dq":
            entry["sass"] = sass["flash_attention"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        row, timing = serve_and_check(torch, np, cfg, workdir, kernels)
        train_report = train_and_check(torch, np, workdir, kernels)
        sagan_report, state, sagan_cfg = sagan_train_and_check(
            torch, np, workdir, kernels)
        sagan_row, sagan_timing = sagan_serve_and_check(
            torch, np, sagan_cfg, state, workdir, kernels)
        del state
        resume_report = resume_and_check(torch, np, workdir, kernels)
    print(json.dumps(row), flush=True)
    print(json.dumps({"sampler": timing}), flush=True)
    print(json.dumps({"train": train_report}), flush=True)
    print(json.dumps(sagan_row), flush=True)
    print(json.dumps({"sagan64_sampler": sagan_timing}), flush=True)
    print(json.dumps({"sagan64_train": sagan_report}), flush=True)
    print(json.dumps({"resume": resume_report}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
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
