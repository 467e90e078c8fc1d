"""The port's int8 serving rung (`dcgan_tpu_torch/serve/quantize.py`) on the
CPU: the same numpy parameter tree through the JAX package's
`quantize_dequantize_int8` and the port's gives equal leaves, bit for bit,
and an equal report (worst_leaf, counts and bytes exactly, max_rel_error
to its 6 decimals); the JAX package's TestInt8Serving cases
(tests/test_precision.py); and a quantized `CheckpointSource` serves both
weight copies quantized."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.models import dcgan as jdcgan
from dcgan_tpu.serve.quantize import quantize_dequantize_int8 as jax_q
from dcgan_tpu_torch.config import ModelConfig, TrainConfig, save_config
from dcgan_tpu_torch.convert import flatten, unflatten
from dcgan_tpu_torch.models.dcgan import generator_init
from dcgan_tpu_torch.serve.quantize import quantize_dequantize_int8
from dcgan_tpu_torch.serve.sources import CheckpointSource
from dcgan_tpu_torch.train.steps import init_train_state, tree_map
from dcgan_tpu_torch.utils.checkpoint import Checkpointer
from torch_jax_draws import one_torch_thread  # noqa: F401

TREES = {
    "dcgan": dict(output_size=16, gf_dim=8, z_dim=8),
    "sagan": dict(output_size=16, gf_dim=8, z_dim=8, attn_res=8,
                  spectral_norm="gd"),
    "celeba64": dict(output_size=64, gf_dim=16, z_dim=100),
}


def _jax_tree(**kw):
    """The JAX generator's params, as nested numpy, scaled per leaf so
    that channels differ in range."""
    params, _ = jdcgan.generator_init(jax.random.key(0), JModelConfig(**kw))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) * rng.uniform(0.5, 3.0, a.shape[-1:])
        .astype(np.float32), params)


def _both(tree_np, dtype=torch.float32):
    """(JAX result as flat numpy, its report, port result flat, report)
    for one numpy tree, cast to `dtype` in both packages."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt),
                                tree_np)
    tt = unflatten({k: torch.from_numpy(np.array(v)).to(dtype)
                    for k, v in flatten(tree_np).items()})
    jout, jrep = jax_q(jt)
    tout, trep = quantize_dequantize_int8(tt)
    jflat = {k: np.asarray(jnp.asarray(v, jnp.float32))
             for k, v in flatten(jax.tree_util.tree_map(
                 lambda a: a, jout)).items()}
    tflat = {k: v.float().numpy() for k, v in flatten(tout).items()}
    return jflat, jrep, tflat, trep


class TestAgainstJax:
    @pytest.mark.parametrize("name", sorted(TREES))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    def test_leaves_and_report_equal(self, name, dtype):
        jflat, jrep, tflat, trep = _both(_jax_tree(**TREES[name]), dtype)
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:
            np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        for key in ("scheme", "quantized_leaves", "worst_leaf",
                    "int8_bytes", "orig_bytes"):
            assert trep[key] == jrep[key], key
        assert round(trep["max_rel_error"], 6) == \
            round(jrep["max_rel_error"], 6)

    def test_worst_leaf_ties_break_in_tree_order(self):
        """Two leaves with the same worst error: both packages name the
        first in tree order (sorted keys)."""
        w = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
        tree = {"zeta": {"w": w.copy()}, "alpha": {"w": w.copy()},
                "alpha2": {"b": np.ones(4, np.float32)}}
        _, jrep, _, trep = _both(tree)
        assert jrep["worst_leaf"] == trep["worst_leaf"] == "alpha/w"

    def test_only_w_leaves_of_rank_two_or_more(self):
        tree = {"a": {"w": np.arange(6, dtype=np.float32)},     # 1-d: kept
                "b": {"w": np.full((2, 3), 0.3, np.float32),
                      "scale": np.full((2, 3), 0.3, np.float32)},
                "w": np.linspace(-1, 1, 12, dtype=np.float32)
                .reshape(3, 4)}
        jflat, jrep, tflat, trep = _both(tree)
        assert trep["quantized_leaves"] == jrep["quantized_leaves"] == 2
        for k in ("a/w", "b/scale"):
            np.testing.assert_array_equal(tflat[k],
                                          flatten(tree)[k])


class TestInt8Serving:
    """tests/test_precision.py::TestInt8Serving on the port's params."""

    def _params(self):
        mcfg = ModelConfig(output_size=16, base_size=4, gf_dim=8, z_dim=8)
        params, _ = generator_init(mcfg, device="cpu")
        return params

    def test_report_and_error_bound(self):
        _, report = quantize_dequantize_int8(self._params())
        assert report["scheme"] == "int8-sym-per-channel"
        assert report["quantized_leaves"] > 0
        assert 0 < report["max_rel_error"] < 0.02
        assert report["int8_bytes"] < report["orig_bytes"]
        assert report["worst_leaf"].endswith("/w")

    def test_only_weight_kernels_touched(self):
        params = self._params()
        qp, _ = quantize_dequantize_int8(params)
        for (path, a), (_, b) in zip(flatten(params).items(),
                                     flatten(qp).items()):
            if path.endswith("/w"):
                assert not torch.equal(a, b), path
            else:
                assert torch.equal(a, b), path


MODEL = dict(output_size=16, gf_dim=8, df_dim=8, z_dim=8,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A checkpoint whose EMA generator differs from the live one."""
    root = str(tmp_path_factory.mktemp("quant"))
    cfg = TrainConfig(model=ModelConfig(**MODEL), batch_size=4)
    state = init_train_state(cfg, device="cpu")
    state["ema_gen"] = tree_map(lambda w: w * 1.7, state["ema_gen"])
    state["step"] = torch.tensor(4, dtype=torch.int32)
    save_config(cfg, root)
    ckpt = Checkpointer(root)
    ckpt.save(4, state)
    ckpt.wait()
    return root, state


class TestQuantizedCheckpointSource:
    @pytest.mark.parametrize("use_ema", [False, True], ids=["live", "ema"])
    def test_serves_the_quantized_copy(self, ckpt_dir, use_ema):
        root, state = ckpt_dir
        src = CheckpointSource(root, use_ema=use_ema, quantize="int8",
                               device="cpu")
        meta = src.prepare()
        want, report = quantize_dequantize_int8(
            state["ema_gen"] if use_ema else state["params"]["gen"])
        assert meta["quantize"] == report
        assert meta["step"] == 4
        for k, v in flatten(want).items():
            assert torch.equal(flatten(src._params)[k], v), k
        # a promotion quantizes the new step too, into the same tensors
        ptrs = {k: v.data_ptr() for k, v in flatten(src._params).items()}
        assert src.reload()["quantize"] == report
        assert {k: v.data_ptr() for k, v in
                flatten(src._params).items()} == ptrs

    def test_both_copies_quantized(self, ckpt_dir):
        root, state = ckpt_dir
        src = CheckpointSource(root, quantize="int8", device="cpu")
        src.prepare()
        restored = Checkpointer(root).restore_latest(
            init_train_state(TrainConfig(model=ModelConfig(**MODEL)),
                             device="cpu"))
        out, _ = src._maybe_quantize(restored)
        for copy in (out["params"]["gen"], out["ema_gen"]):
            for k, v in flatten(copy).items():
                if k.endswith("/w"):
                    # every channel holds at most 255 levels of its scale
                    lv = v.reshape(-1, v.shape[-1])
                    scale = lv.abs().amax(0) / 127.0
                    q = lv / scale
                    assert torch.allclose(q, q.round(), atol=1e-3), k
        assert not torch.equal(out["params"]["gen"]["proj"]["w"],
                               out["ema_gen"]["proj"]["w"])

    def test_unknown_scheme_raises(self, ckpt_dir):
        with pytest.raises(ValueError, match="quantize"):
            CheckpointSource(ckpt_dir[0], quantize="int4", device="cpu")
