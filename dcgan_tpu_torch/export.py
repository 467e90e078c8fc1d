"""Serialized serving artifact: checkpoint -> a `torch.export` sampler with
the weights in it (the counterpart of `dcgan_tpu/export.py`).

`python -m dcgan_tpu_torch.export` bakes a checkpoint's generator into one
`torch.export` program, saved with `torch.export.save` as a `.pt2`, that

- has a symbolic batch dimension (`torch.export.Dim`; any batch size at
  call time, or one pinned by --batch_size),
- needs nothing of this package to run: any process with torch can
  `torch.export.load(path).module()(z)`.

The program is the sampler's plain route: cuDNN convolutions, torch
BatchNorm and dense attention, whatever route the checkpoint trained on.
The JAX exporter does the same (its artifact must be pure StableHLO, with
no Pallas call in it); the port's kernels are not in the artifact either,
so it holds no custom op. A kernel-route checkpoint's weights serve
through the plain route unchanged: the parameters do not depend on the
route. The program runs on the device it was exported on (`--device`),
which the sidecar names under `platforms`.

Usage:
    python -m dcgan_tpu_torch.export --checkpoint_dir C --out sampler.pt2
    python -m dcgan_tpu_torch.export --checkpoint_dir C --use_ema \
        --out sampler.pt2 --quantize int8 --device cuda

    # serving side, no dcgan_tpu_torch import needed:
    sampler = torch.export.load("sampler.pt2").module()
    images = sampler(z)                    # z [b, z_dim] f32 ~ U(-1, 1)
    images = sampler(z, labels)            # a conditional model: labels
                                           # [b] int32 class ids

A JSON sidecar (`<out>.json`) holds the calling convention with the JAX
sidecar's keys: z_dim, num_classes, image shape, checkpoint step, weight
source (live or EMA), the devices it was checked on, its bytes, and a
`serving` block (weight source, int8 report, bucket-ladder hint, z
distribution), so `python -m dcgan_tpu_torch.serve --artifact <out>`
cold-starts from the artifact alone. It also records the torch version
that wrote the program (`torch`): a `.pt2` may not load in another
version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

import torch

#: the batch the program is traced at: 1 would be specialized into it
_TRACE_BATCH = 2
#: the largest batch a symbolic-batch program takes
_MAX_BATCH = 1 << 16
#: the program against the sampler it was traced from, by compute dtype
#: (the sampler's tolerances of tests/test_torch_models.py): the two may
#: take other convolution algorithms
_CHECK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


class _Sampler(torch.nn.Module):
    """The generator's plain-route sampler with its params and BN state as
    buffers, so `torch.export` saves them in the program."""

    def __init__(self, cfg, params, state):
        from dcgan_tpu_torch.convert import flatten
        from dcgan_tpu_torch.train.steps import tree_map

        super().__init__()
        self.cfg = cfg
        self._names = {}
        # the trees' layout without their tensors: an empty subtree (a
        # BN-free generator's state) has no buffer to bring it back
        self._layout = tree_map(lambda t: None,
                                {"params": params, "state": state})
        for path, t in flatten({"params": params, "state": state}).items():
            name = path.replace("/", "__")
            self.register_buffer(name, t.detach().clone())
            self._names[path] = name

    def forward(self, z: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        from dcgan_tpu_torch.convert import unflatten
        from dcgan_tpu_torch.models.dcgan import generator_apply

        tree = unflatten({path: getattr(self, name)
                          for path, name in self._names.items()},
                         like=self._layout)
        img, _ = generator_apply(tree["params"], tree["state"], z,
                                 cfg=self.cfg, train=False, labels=labels)
        return img


def export_sampler(checkpoint_dir: str, out_path: str, *,
                   preset: Optional[str] = None,
                   overrides: Optional[dict] = None,
                   use_ema: bool = False,
                   batch_size: int = 0,
                   max_serve_batch: int = 64,
                   quantize: str = "",
                   device: str = "cuda") -> dict:
    """Bake the checkpoint's generator into a `.pt2` program at
    `out_path` and write its sidecar; returns the sidecar's dict.

    batch_size=0 exports a symbolic batch dimension; a positive value pins
    it. `max_serve_batch` sizes the sidecar's bucket-ladder hint (a pinned
    batch makes the ladder that one rung). `quantize="int8"` bakes the
    int8 quantize-dequantized weights, and the sidecar's serving block
    carries the report. The program is checked on `device` against the
    sampler it was traced from before the sidecar names the device."""
    from dcgan_tpu_torch.config import consumer_train_config, \
        resolve_model_config
    from dcgan_tpu_torch.device import resolve_device
    from dcgan_tpu_torch.models.dcgan import generator_apply
    from dcgan_tpu_torch.serve.buckets import build_ladder
    from dcgan_tpu_torch.train.steps import init_train_state, tree_map
    from dcgan_tpu_torch.utils.checkpoint import Checkpointer

    if quantize not in ("", "int8"):
        raise ValueError(f"quantize must be '' or 'int8', got {quantize!r}")
    dev = resolve_device(device)
    mcfg = resolve_model_config(checkpoint_dir, preset=preset,
                                overrides=overrides)
    template = init_train_state(consumer_train_config(checkpoint_dir, mcfg),
                                device="cpu")
    state = Checkpointer(checkpoint_dir).restore_latest(template)
    if state is None:
        raise SystemExit(f"no checkpoint under {checkpoint_dir}")
    del template
    # the plain route: the program holds no kernel of the port
    mcfg = dataclasses.replace(mcfg, use_pallas=False, bn_pallas=None,
                               pallas_fused=False)
    step = int(state["step"])
    g_params = state["ema_gen"] if use_ema else state["params"]["gen"]
    quant_report = None
    if quantize == "int8":
        from dcgan_tpu_torch.serve.quantize import quantize_dequantize_int8

        g_params, quant_report = quantize_dequantize_int8(g_params)

    module = _Sampler(mcfg, g_params, state["bn"]["gen"]).to(dev)
    trace = batch_size if batch_size > 0 else _TRACE_BATCH
    z = torch.rand((trace, mcfg.z_dim), generator=torch.Generator()
                   .manual_seed(0)) * 2.0 - 1.0
    z = z.to(dev)
    # a conditional model's program is called as (z, labels); the check
    # below runs every class
    k = mcfg.num_classes
    args = (z,) if not k else (
        z, (torch.arange(trace, dtype=torch.int32) % k).to(dev))
    dynamic = None
    if batch_size <= 0:
        b = torch.export.Dim("b", min=1, max=_MAX_BATCH)
        dynamic = {"z": {0: b}} if not k else {"z": {0: b},
                                               "labels": {0: b}}
    program = torch.export.export(module, args, dynamic_shapes=dynamic)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)

    # the saved program, loaded back, against the sampler it was traced
    # from, on the device (at batch 1 too when the batch is symbolic)
    loaded = torch.export.load(out_path).module()
    params, bn = (tree_map(lambda t: t.to(dev), tree)
                  for tree in (g_params, state["bn"]["gen"]))
    tol = _CHECK_TOL[mcfg.compute_dtype]
    checks = [args] if batch_size > 0 else [
        args, tuple(a[:1] for a in args)]
    if k and batch_size <= 0:
        # every class at once, whatever the trace batch
        zk = torch.rand((k, mcfg.z_dim), generator=torch.Generator()
                        .manual_seed(1)).to(dev) * 2.0 - 1.0
        checks.append((zk, torch.arange(k, dtype=torch.int32).to(dev)))
    for call in checks:
        with torch.no_grad():
            got = loaded(*call)
            want, _ = generator_apply(params, bn, call[0], cfg=mcfg,
                                      train=False,
                                      labels=call[1] if k else None)
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err <= tol:
            raise RuntimeError(
                f"the exported program differs from the sampler on {dev} "
                f"at batch {call[0].shape[0]}: {tuple(got.shape)}, max "
                f"|err| {err} > {tol}")

    meta = {
        "format": "torch.export ExportedProgram",
        "call": ("(z[b, z_dim] f32, labels[b] i32) -> images" if k
                 else "(z[b, z_dim] f32) -> images"),
        "z_dim": mcfg.z_dim,
        "num_classes": mcfg.num_classes or 0,
        "image_shape": [mcfg.output_size, mcfg.output_size, mcfg.c_dim],
        "batch": batch_size if batch_size > 0 else "b (symbolic)",
        "arch": mcfg.arch,
        "step": step,
        "weights": "ema" if use_ema else "live",
        "platforms": [dev.type],
        "bytes": os.path.getsize(out_path),
        "torch": torch.__version__,
        # what `python -m dcgan_tpu_torch.serve --artifact` needs to cold
        # start: which weights the program carries and the ladder to
        # capture (an explicit --buckets overrides the hint)
        "serving": {
            "source": "ema" if use_ema else "live",
            **({"quantize": quant_report} if quant_report else {}),
            "bucket_ladder": (
                [batch_size] if batch_size > 0
                else list(build_ladder(max_serve_batch).buckets)),
            "z_dist": "uniform(-1,1)",
        },
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_sampler(path: str):
    """The exported sampler as a callable module: z [b, z_dim] (and, for a
    conditional model, labels [b]) -> images.
    Serving needs nothing of this package (`torch.export.load` is the
    whole protocol)."""
    return torch.export.load(path).module()


def build_parser() -> argparse.ArgumentParser:
    from dcgan_tpu_torch.config import add_model_override_flags

    p = argparse.ArgumentParser(
        prog="dcgan_tpu_torch.export",
        description="export a trained sampler as one torch.export program "
                    "(weights baked in)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--out", default="sampler.pt2")
    p.add_argument("--use_ema", action="store_true",
                   help="bake the EMA generator weights instead of the live "
                        "ones")
    p.add_argument("--device", default="cuda",
                   help="the device the program is exported for and checked "
                        "on (default cuda; the CPU only when asked for by "
                        "name)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="pin the batch dimension (default 0 = symbolic: any "
                        "batch size at call time)")
    p.add_argument("--max_serve_batch", type=int, default=64,
                   help="top rung of the sidecar's serving bucket-ladder "
                        "hint (symbolic-batch artifacts only)")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="post-training quantize the baked-in generator "
                        "weights (int8 symmetric per-channel); the sidecar "
                        "serving block records scheme + measured error")
    p.add_argument("--preset", default=None,
                   help="named config supplying the architecture instead of "
                        "the checkpoint's config.json")
    add_model_override_flags(p)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from dcgan_tpu_torch.config import MODEL_OVERRIDE_FLAGS

    meta = export_sampler(
        args.checkpoint_dir, args.out, preset=args.preset,
        overrides={n: getattr(args, n) for n in MODEL_OVERRIDE_FLAGS},
        use_ema=args.use_ema, batch_size=args.batch_size,
        max_serve_batch=args.max_serve_batch, quantize=args.quantize,
        device=args.device)
    print(f"[dcgan_tpu_torch.export] step-{meta['step']} {meta['weights']} "
          f"sampler ({meta['arch']}, {meta['bytes']} bytes, "
          f"platforms {','.join(meta['platforms'])}) -> {args.out}")


if __name__ == "__main__":
    main()
