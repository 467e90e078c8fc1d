#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dcgan_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU (sm_90a) and
nvcc. Needs one card; no network. Phases, each fatal on failure:

1. build: every CUDA kernel of the served path, from dcgan_tpu_torch/csrc
   (nvcc, one process per source, all at once);
2. kernels: each kernel against its plain PyTorch version on the same card
   tensors at the shapes the served path gives it (celeba64, batch 64), in
   bf16 and f32, plus ragged shapes; then timed with CUDA events beside its
   bound, its plain version and a library call;
3. serve: seeded celeba64 weights (use_pallas + pallas_fused, BN running
   statistics calibrated on a batch and perturbed with numpy noise) are
   written with convert.save_weights and served through
   `python -m dcgan_tpu_torch.serve`'s entry point on cuda, 24 demo
   requests of 1-8 images; the kernels' launch counters are set to 0 just
   before and read just after, and must both have risen;
4. outputs: every served image is finite, in [-1, 1], shape [n, 64, 64, 3];
   requests match a direct sampler call on the same z rows; one batch
   matches the cuDNN + torch-BN route (use_pallas=False), in bf16 and, with
   TF32 off, in f32; then one bf16 sampler call at batch 64 is timed on
   both routes.

Stdout ends with the serve report, the sampler timing, the card's name
and power limit
(nvidia-smi), one JSON line {"kernels": [...]} and, last, one JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits nonzero, printing no result, when no GPU is available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over HBM bandwidth and its operations over these rates
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 2):
    """(device ms, call ms) of one fn(), each a mean over `iters` calls.

    call ms: host clock around back-to-back calls ending in a synchronize,
    so it includes the wrapper's Python and launch overhead. device ms:
    CUDA events around the same calls enqueued behind a spin kernel that
    holds the stream until the host has queued them all, so the calls run
    back to back on the card and host overhead is hidden."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles >= the enqueue time at clocks up to 2 GHz, plus 2 ms
    torch.cuda._sleep(int((call_ms * iters + 2.0) * 2e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, call_ms


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


def check_kernels(torch, cfg):
    """Phase 2: kernels vs plain versions, then timings. Returns the
    per-kernel entries of the kernels line (launches filled later)."""
    from dcgan_tpu_torch.ops.activations import ACTS
    from dcgan_tpu_torch.ops.fused import conv_patches, \
        gemm_bias_scale_act, gemm_bias_scale_act_plain, w_to_gemm
    from dcgan_tpu_torch.ops.kernels import scale_shift_act, \
        scale_shift_act_plain

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
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        for shape in ((n0, top), (37, 70)):   # served shape, then ragged
            x = rand(*shape).to(dt)
            _, scale, shift = vectors(shape[1])
            for act in ACTS:
                got = scale_shift_act(x, scale, shift, act)
                want = scale_shift_act_plain(x, scale, shift, act)
                torch.cuda.synchronize()
                err = check_close(torch, f"scale_shift_act {dt_name} "
                                  f"{shape} {act}", got, want, dt_name)
                if shape == (n0, top):
                    errs[dt_name] = max(errs.get(dt_name, 0.0), err)
    log(f"scale_shift_act matches its plain version (max |err| bf16 "
        f"{errs['bfloat16']:.3g}, f32 {errs['float32']:.3g})")
    x = rand(n0, top).clamp_min(0).to(torch.bfloat16)
    _, scale, shift = vectors(top)
    ssa["ms"], ssa["call_ms"] = time_ms(
        torch, lambda: scale_shift_act(x, scale, shift, "relu"), 200)
    ssa["plain_ms"], _ = time_ms(torch, lambda: scale_shift_act_plain(
        x, scale, shift, "relu"), 100)
    ssa["library_ms"], _ = time_ms(torch, lambda: torch.relu(
        x.float() * scale + shift).to(x.dtype), 100)
    t_bytes, t_ops = ssa_bound(n0, top)
    ssa["bound_ms"] = max(t_bytes, t_ops) * 1e3
    ssa["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    ssa["max_abs_err"] = errs["bfloat16"]
    ssa["max_abs_err_f32"] = errs["float32"]

    # ---- gemm_bias_scale_act at the fused stages -------------------------
    gemm = {"name": "gemm_bias_scale_act", "route": "cuda",
            "source": "dcgan_tpu_torch/csrc/gemm_bias_scale_act.cu",
            "replaces": "dcgan_tpu/ops/pallas_fused.py:229", "stages": []}
    for act in ACTS:   # ragged M, K, C: the masked, unaligned load path
        for dt_name, dt in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            p, w = rand(100, 37).to(dt), (0.1 * rand(37, 70)).to(dt)
            b, scale, shift = vectors(70)
            check_close(torch, f"gemm_bias_scale_act ragged {dt_name} {act}",
                        gemm_bias_scale_act(p, w, b, scale, shift, act,
                                            out_dtype=dt),
                        gemm_bias_scale_act_plain(p, w, b, scale, shift, act,
                                                  out_dtype=dt), dt_name)
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
            got = gemm_bias_scale_act(p2d, w2d, b, scale, shift, "relu",
                                      out_dtype=dt)
            want = gemm_bias_scale_act_plain(p2d, w2d, b, scale, shift,
                                             "relu", out_dtype=dt)
            torch.cuda.synchronize()
            stage[f"max_abs_err_{dt_name}"] = check_close(
                torch, f"gemm_bias_scale_act {name} {dt_name}", got, want,
                dt_name)
            del got, want
            if dt is torch.bfloat16:
                stage["ms"], stage["call_ms"] = time_ms(
                    torch, lambda: gemm_bias_scale_act(
                        p2d, w2d, b, scale, shift, "relu",
                        out_dtype=torch.bfloat16), 20)
                stage["plain_ms"], _ = time_ms(
                    torch, lambda: gemm_bias_scale_act_plain(
                        p2d, w2d, b, scale, shift, "relu",
                        out_dtype=torch.bfloat16), 10)
                stage["library_ms"], _ = time_ms(torch, lambda: torch.relu(
                    (torch.matmul(p2d, w2d).float() + b) * scale + shift
                ).to(torch.bfloat16), 20)
                # the im2col that feeds the kernel on the served path
                stage["im2col_ms"], _ = time_ms(torch, lambda: conv_patches(
                    h, cfg.kernel_size, 2, transpose=True), 10)
                t_bytes, t_ops = gemm_bound(m, k, c)
                stage["bound_ms"] = max(t_bytes, t_ops) * 1e3
                stage["bound_by"] = "bytes" if t_bytes >= t_ops \
                    else "operations"
            del h, p2d, w2d
            torch.cuda.empty_cache()
        log(f"gemm_bias_scale_act {name} M={m} K={k} C={c} matches its "
            f"plain version (max |err| bf16 "
            f"{stage['max_abs_err_bfloat16']:.3g}, f32 "
            f"{stage['max_abs_err_float32']:.3g}); {stage['ms']:.4f} ms vs "
            f"bound {stage['bound_ms']:.4f} ms ({stage['bound_by']}); its "
            f"im2col {stage['im2col_ms']:.4f} ms")
        gemm["stages"].append(stage)
    st = gemm["stages"]
    for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                "im2col_ms"):
        gemm[key] = sum(s[key] for s in st)   # one sampler call at B=64
    gemm["bound_by"] = "bytes" if all(s["bound_by"] == "bytes"
                                      for s in st) else "operations"
    gemm["max_abs_err"] = max(s["max_abs_err_bfloat16"] for s in st)
    gemm["max_abs_err_f32"] = max(s["max_abs_err_float32"] for s in st)
    return [ssa, gemm]


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


def serve_and_check(torch, np, cfg, workdir, kernels):
    """Phases 3 and 4."""
    from dcgan_tpu_torch.convert import load_weights, save_weights
    from dcgan_tpu_torch.models.dcgan import sampler_apply
    from dcgan_tpu_torch.ops.fused import gemm_bias_scale_act
    from dcgan_tpu_torch.ops.kernels import scale_shift_act
    from dcgan_tpu_torch.serve import __main__ as serve_main

    params, state = calibrated_weights(torch, np, cfg)
    path = save_weights(os.path.join(workdir, "celeba64.npz"), cfg, params,
                        state)
    report_path = os.path.join(workdir, "serve_report.json")
    wrappers = {"scale_shift_act": scale_shift_act,
                "gemm_bias_scale_act": gemm_bias_scale_act}

    for fn in wrappers.values():
        fn.launches = 0
    row, responses = serve_main.run([
        "--weights", path, "--device", "cuda", "--max_batch", str(BATCH),
        "--demo_requests", str(N_REQUESTS), "--demo_rps", "500",
        "--demo_max_images", "8", "--seed", str(SEED),
        "--report", report_path])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    log(f"served path launches: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} was not launched on the served path")

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
            torch, lambda: sampler_apply(params_l, state_l, z, cfg=route), 20)
    log(f"sampler at batch {BATCH}: kernel route "
        f"{timing['kernel_route_ms']:.4f} ms, cuDNN + torch-BN route "
        f"{timing['cudnn_route_ms']:.4f} ms (device); host-inclusive "
        f"{timing['kernel_route_call_ms']:.4f} / "
        f"{timing['cudnn_route_call_ms']:.4f} ms")
    return row, timing


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
    for name, lib in sorted(libs.items()):
        report = lib.with_name(lib.name + ".log")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    cfg = celeba64(use_pallas=True, pallas_fused=True)
    kernels = check_kernels(torch, cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        row, timing = serve_and_check(torch, np, cfg, workdir, kernels)
    print(json.dumps(row), flush=True)
    print(json.dumps({"sampler": timing}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for entry in kernels:
        entry["kernel_ms"] = entry["ms"]
        entry["bound_us"] = entry["bound_ms"] * 1e3
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
