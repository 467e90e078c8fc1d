"""Post-training int8 quantization of the served generator (the counterpart
of `dcgan_tpu/serve/quantize.py`).

Samplers tolerate far more quantization than training (no gradients, one
forward per request), so the served weights may go through int8 while
training stays on its f32/bf16 policies. The quantization report rides the
server's metadata and an exported artifact's sidecar, so a quantized fleet
is seen to be quantized.

Mechanics, as in the JAX package: symmetric per-output-channel int8 (scale
= amax / 127 over each kernel's last axis, which is the output channel of
both packages' HWIO conv and deconv kernels and `[in, out]` linear
weights), quantize-DEquantize at load time. The tree keeps its dtypes and
shapes, so the rungs, the export and the kernels see the same tensors: the
rung is a transform of the weights, not a new execution path.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

Pytree = Any

#: the leaves quantized: weight matrices and kernels ("w", ndim >= 2).
#: Biases, BN affines and statistics and SN vectors stay exact.
_QUANT_LEAF = "w"


def quantize_dequantize_int8(tree: Pytree) -> Tuple[Pytree, dict]:
    """(tree', report): every eligible weight leaf of a nested dict of
    tensors round-tripped through symmetric per-output-channel int8. Leaves
    are walked in `convert.flatten`'s sorted order, which is JAX's tree
    order, so `worst_leaf` breaks ties as the JAX function does; the report
    has its keys and values."""
    from dcgan_tpu_torch.convert import flatten, unflatten

    out = {}
    quantized = 0
    worst_rel = 0.0
    worst_path = ""
    total_bytes = 0
    quant_bytes = 0
    for p, leaf in flatten(tree).items():
        total_bytes += leaf.numel() * leaf.element_size()
        if not (p.endswith("/" + _QUANT_LEAF) or p == _QUANT_LEAF) \
                or leaf.ndim < 2:
            out[p] = leaf
            continue
        xf = leaf.float()
        # per output channel: the last axis of HWIO kernels and [in, out]
        # linears; each channel gets its own amax scale
        amax = xf.abs().amax(dim=tuple(range(leaf.ndim - 1)), keepdim=True)
        scale = amax.clamp_min(1e-12) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        deq = (q.float() * scale).to(leaf.dtype)
        denom = max(float(xf.abs().max()), 1e-12)
        rel = float((deq.float() - xf).abs().max()) / denom
        if rel > worst_rel:
            worst_rel, worst_path = rel, p
        quantized += 1
        quant_bytes += leaf.numel()  # 1 byte an element if kept as int8
        out[p] = deq
    report = {
        "scheme": "int8-sym-per-channel",
        "quantized_leaves": quantized,
        "max_rel_error": round(worst_rel, 6),
        "worst_leaf": worst_path,
        "int8_bytes": int(quant_bytes),
        "orig_bytes": int(total_bytes),
    }
    return unflatten(out, like=tree), report
