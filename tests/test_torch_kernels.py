"""The ported kernels: plain versions (and the autograd Functions built on
them) against the JAX kernels and their custom VJPs on the CPU, and the
CUDA kernels against their plain versions on the card. The flash-attention
plain versions are held against JAX in tests/test_torch_attention.py; their
kernels against them on the card here (TestFlashOnCard).

On the CPU the wrappers take the plain PyTorch versions (a CPU tensor is
the only thing that selects them); the JAX side runs the Pallas kernels in
interpret mode, as the JAX package's own tests do. Tolerances:
- f32: 1e-5 (summation order only);
- bf16 outputs: one bf16 ulp of each value, |a - b| <= 2^-7 |b| + 1e-6,
  since both compute in f32 and round once, possibly to neighbours;
- f32 column sums (moments, dscale, dshift, db): 1e-5 of the sum of the
  terms' magnitudes, the bound of an f32 sum taken in another order.

The `cuda`-marked tests need the card and skip without one; on a GPU
machine run them with
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
(--noconftest: the suite's conftest imports JAX, which the GPU machine
does not need). This module imports JAX only inside the fixture that needs
it, so those runs collect it without JAX.
"""

import math
import re
import types

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.ops import flash_attention as flash
from dcgan_tpu_torch.ops import _build, fused, kernels
from dcgan_tpu_torch.ops.activations import ACTS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's intra-op pool held to one thread on the CPU, as
    tests/torch_jax_draws.py::one_torch_thread does for the JAX-importing
    port tests (this file also runs on the card, without JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16_ULP = 2.0 ** -7
ACT_LIST = list(ACTS)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's kernels (Pallas interpret mode on the CPU)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from dcgan_tpu.ops import pallas_fused, pallas_kernels

    return types.SimpleNamespace(jax=jax, jnp=jnp, fused=pallas_fused,
                                 kernels=pallas_kernels)


@pytest.fixture
def cuda():
    """The card, with TF32 off for the f32 comparisons (cuDNN defaults to
    it; the plain versions' f32 matmuls must stay full f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        saved


def _np(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _assert_close(got, want, dtype):
    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    w = want.detach().float().cpu().numpy() if torch.is_tensor(want) \
        else want
    if dtype == torch.bfloat16:
        bad = np.abs(g - w) > BF16_ULP * np.abs(w) + 1e-6
        assert not bad.any(), f"{bad.sum()} elements beyond one bf16 ulp"
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _j2np(jnp, x):
    return np.asarray(jnp.asarray(x, jnp.float32))


DTYPES = [(torch.float32, "float32"), (torch.bfloat16, "bfloat16")]


class TestScaleShiftActPlain:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("shape", [(24, 40), (7, 13)])
    def test_matches_jax(self, jref, act, tdt, jname, shape):
        jnp = jref.jnp
        x = _np(0, shape, -2, 2)
        scale, shift = _np(1, shape[1:], 0.5, 1.5), _np(2, shape[1:])
        got = kernels.scale_shift_act(torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(scale),
                                      torch.from_numpy(shift), act)
        want = jref.kernels.scale_shift_act(
            jnp.asarray(x, jnp.dtype(jname)), jnp.asarray(scale),
            jnp.asarray(shift), act)
        assert got.dtype == tdt
        _assert_close(got, _j2np(jnp, want), tdt)

    def test_fused_bn_act_matches_jax(self, jref):
        jnp = jref.jnp
        x = _np(3, (2, 4, 4, 8), -2, 2)
        g, b, m = _np(4, (8,), 0.5, 1.5), _np(5, (8,)), _np(6, (8,))
        v = _np(7, (8,), 0.2, 2.0)
        got = kernels.fused_bn_act(*(torch.from_numpy(a)
                                     for a in (x, g, b, m, v)),
                                   eps=1e-5, act="relu")
        want = jref.kernels.fused_bn_act(*(jnp.asarray(a)
                                           for a in (x, g, b, m, v)),
                                         eps=1e-5, act="relu")
        assert tuple(got.shape) == x.shape
        _assert_close(got, _j2np(jnp, want), torch.float32)

    def test_cpu_takes_plain_version_without_counting(self):
        before = kernels.scale_shift_act.launches
        x = torch.from_numpy(_np(8, (4, 6)))
        y = kernels.scale_shift_act(x, torch.ones(6), torch.zeros(6), "relu")
        assert kernels.scale_shift_act.launches == before
        torch.testing.assert_close(y, torch.relu(x))

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="unknown act"):
            kernels.scale_shift_act(torch.zeros(2, 3), torch.ones(3),
                                    torch.zeros(3), "gelu")
        with pytest.raises(ValueError, match="2-D"):
            kernels.scale_shift_act(torch.zeros(2, 3, 4), torch.ones(4),
                                    torch.zeros(4))


class TestGemmBiasScaleActPlain:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (64, 96, 16), (5, 1, 3)])
    def test_matches_jax_ragged(self, jref, act, tdt, jname, mkc):
        jnp = jref.jnp
        m, k, c = mkc
        p, w = _np(10, (m, k)), _np(11, (k, c), -0.3, 0.3)
        b, scale, shift = _np(12, (c,)), _np(13, (c,), 0.5, 1.5), \
            _np(14, (c,))
        jdt = jnp.dtype(jname)
        got = fused.gemm_bias_scale_act(
            torch.from_numpy(p).to(tdt), torch.from_numpy(w).to(tdt),
            torch.from_numpy(b), torch.from_numpy(scale),
            torch.from_numpy(shift), act, 0.2, tdt)
        want = jref.fused.gemm_bias_scale_act(
            jnp.asarray(p, jdt), jnp.asarray(w, jdt), jnp.asarray(b),
            jnp.asarray(scale), jnp.asarray(shift), act, 0.2, jdt)
        assert got.dtype == tdt and tuple(got.shape) == (m, c)
        _assert_close(got, _j2np(jnp, want), tdt)

    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_fused_stage_matches_jax(self, jref, tdt, jname):
        """fused_conv_bn_act(train=False), the whole interior G stage."""
        jnp = jref.jnp
        x = _np(20, (2, 4, 4, 6), 0, 1)
        w, b = _np(21, (5, 5, 6, 10), -0.1, 0.1), _np(22, (10,), -0.1, 0.1)
        gamma, beta = _np(23, (10,), 0.5, 1.5), _np(24, (10,))
        mean, var = _np(25, (10,), -0.2, 0.2), _np(26, (10,), 0.1, 0.5)
        jdt = jnp.dtype(jname)
        got, state = fused.fused_conv_bn_act(
            {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
            {"scale": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)},
            {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
            torch.from_numpy(x), transpose=True, kernel=5, train=False,
            act="relu", compute_dtype=tdt)
        want, _ = jref.fused.fused_conv_bn_act(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
            jnp.asarray(x), transpose=True, kernel=5, train=False,
            act="relu", compute_dtype=jdt)
        assert got.dtype == tdt and tuple(got.shape) == (2, 8, 8, 10)
        _assert_close(got, _j2np(jnp, want), tdt)
        assert state["mean"] is not None

    def test_fused_train_mode_not_ported_yet(self, jref):
        """fused_conv_bn_act(train=True), a whole D stage in f32: output,
        new BN state and every gradient against JAX's, 1e-5 (the name
        dates from before the train half was ported)."""
        _check_fused_train_stage(jref, transpose=False, act="lrelu",
                                 tdt=torch.float32, jname="float32")

    def test_rejects_bad_arguments(self):
        p, w = torch.zeros(4, 3), torch.zeros(5, 2)
        v = torch.zeros(2)
        with pytest.raises(ValueError, match="p2d"):
            fused.gemm_bias_scale_act(p, w, v, v, v)
        with pytest.raises(TypeError, match="dtypes differ"):
            fused.gemm_bias_scale_act(torch.zeros(4, 5), w.bfloat16(), v, v,
                                      v)
        with pytest.raises(TypeError, match="out_dtype"):
            fused.gemm_bias_scale_act(torch.zeros(4, 5), w, v, v, v,
                                      out_dtype=torch.float16)


class TestGbsaPlan:
    """The launch plan of gemm_bias_scale_act (`fused.gbsa_plan`): a
    dispatch by dtype, shape and alignment, pinned on an H100's 132 SMs."""

    # celeba64's three served stages at batch 64: (M, K, C)
    CELEBA64 = [(4096, 12800, 256), (16384, 6400, 128), (65536, 3200, 64)]

    @pytest.mark.parametrize("mkc", CELEBA64)
    def test_celeba64_stages_take_v2_with_all_of_c(self, mkc):
        m, k, c = mkc
        plan = fused.gbsa_plan(m, k, c, torch.bfloat16, True, 132)
        assert plan.design == "v2" and plan.bn == c
        assert plan.bm == fused.GBSA_V2_BM
        assert 2 <= plan.stages <= fused.GBSA_V2_MAX_STAGES
        # the CTAs fill the card (within one CTA per 32 SMs of a full
        # wave) and a doubled split would not fit at once
        resident = 132 * (2 if plan.bn == 64 else 1)
        assert plan.ctas(m, c) >= 132 * 31 // 32
        assert plan.splits == 1 or 2 * plan.ctas(m, c) > resident
        # every split keeps at least its share of K blocks
        blocks = -(-k // fused.GBSA_V2_BK)
        assert blocks >= plan.splits * fused.GBSA_V2_MIN_KB_PER_SPLIT

    def test_first_stage_splits_k(self):
        plan = fused.gbsa_plan(4096, 12800, 256, torch.bfloat16, True, 132)
        assert (plan.splits, plan.ctas(4096, 256)) == (4, 128)

    @pytest.mark.parametrize("mkc, aligned", [
        ((100, 37, 70), False),      # K and C not multiples of 8
        ((1000, 200, 72), False),    # aligned shape, unaligned pointers
        ((4096, 12800, 256), False)])
    def test_unaligned_takes_v1(self, mkc, aligned):
        m, k, c = mkc
        plan = fused.gbsa_plan(m, k, c, torch.bfloat16, aligned, 132)
        assert plan.design == "v1" and plan.bm == 128 and plan.stages == 2
        assert plan.bn == (64 if c <= 64 else 128)

    def test_aligned_ragged_shape_takes_v2(self):
        plan = fused.gbsa_plan(1000, 200, 72, torch.bfloat16, True, 132)
        assert plan == fused.GbsaPlan("v2", fused.GBSA_V2_BM, 128,
                                      plan.stages, 1)

    def test_f32_takes_simt_unsplit(self):
        assert fused.gbsa_plan(4096, 12800, 256, torch.float32, True, 132) \
            == fused.GbsaPlan("simt", 64, 64, 1, 1)

    @pytest.mark.parametrize("args, err", [
        ((0, 8, 8, torch.bfloat16, True, 132), ValueError),
        ((8, 8, 8, torch.bfloat16, True, 0), ValueError),
        ((8, 8, 8, torch.float16, True, 132), TypeError),
        ((8, 12, 8, torch.bfloat16, True, 132), ValueError)])
    def test_bad_arguments_raise(self, args, err):
        with pytest.raises(err):
            fused.gbsa_plan(*args)

    def test_constants_match_the_kernel_source(self):
        """The plan's v2 tile constants are the kernel's (the launch
        refuses a plan that disagrees)."""
        src = (_build.SRC_DIR / "gemm_wgmma.cuh").read_text()

        def const(name):   # an int literal or a product, "200 * 1024"
            m = re.search(rf"constexpr int {name} = ([\d *]+);", src)
            return math.prod(int(x) for x in m.group(1).split("*"))

        assert (const("kBM"), const("kMaxStages"), const("kBK"),
                const("kSmemBudget")) == (
            fused.GBSA_V2_BM, fused.GBSA_V2_MAX_STAGES, fused.GBSA_V2_BK,
            fused.GBSA_V2_SMEM_BUDGET)


class TestGbmPlan:
    """The launch plan of gemm_bias_moments: `gbsa_plan` itself, reached
    through `gemm_plan`, which computes `aligned` from K, C and both data
    pointers (TMA's rule); pinned on an H100's 132 SMs."""

    # celeba64's six fused training stages at batch 64: (M, K, C) and the
    # plan's column tile and K splits
    CELEBA64 = [(4096, 12800, 256, 256, 4),    # G deconv1
                (16384, 6400, 128, 128, 1),    # G deconv2
                (65536, 3200, 64, 64, 1),      # G deconv3
                (16384, 1600, 128, 128, 1),    # D conv1
                (4096, 3200, 256, 256, 4),     # D conv2
                (1024, 6400, 512, 256, 8)]     # D conv3

    @pytest.mark.parametrize("m, k, c, bn, splits", CELEBA64)
    def test_celeba64_stages_take_v2(self, m, k, c, bn, splits):
        plan = fused.gbsa_plan(m, k, c, torch.bfloat16, True, 132)
        assert (plan.design, plan.bm, plan.bn, plan.splits) == (
            "v2", fused.GBSA_V2_BM, bn, splits)
        assert 2 <= plan.stages <= fused.GBSA_V2_MAX_STAGES
        # the splits fill the card: a doubled split would not fit at once
        resident = 132 * (2 if bn == 64 else 1)
        assert 2 * plan.ctas(m, c) > resident or \
            -(-k // fused.GBSA_V2_BK) < 2 * splits \
            * fused.GBSA_V2_MIN_KB_PER_SPLIT

    # (M, K, C), dtype, pointer offsets of P and W in elements, the design
    @pytest.mark.parametrize("mkc, dtype, offsets, design", [
        ((1000, 200, 72), torch.bfloat16, (0, 0), "v2"),
        ((100, 37, 70), torch.bfloat16, (0, 0), "v1"),    # K and C
        ((100, 40, 70), torch.bfloat16, (0, 0), "v1"),    # C % 8
        ((100, 37, 72), torch.bfloat16, (0, 0), "v1"),    # K % 8
        ((1000, 200, 72), torch.bfloat16, (1, 0), "v1"),  # P unaligned
        ((1000, 200, 72), torch.bfloat16, (0, 4), "v1"),  # W unaligned
        ((1000, 200, 72), torch.bfloat16, (8, 8), "v2"),  # 16 bytes off
        ((1000, 200, 72), torch.float32, (0, 0), "simt"),
        ((100, 37, 70), torch.float32, (1, 1), "simt")])
    def test_operands_pick_the_design(self, mkc, dtype, offsets, design):
        m, k, c = mkc
        p = _at_offset(torch.zeros(m, k, dtype=dtype), offsets[0])
        w = _at_offset(torch.zeros(k, c, dtype=dtype), offsets[1])
        plan = fused.gemm_plan(p, w, 132)
        aligned = design == "v2"
        assert plan == fused.gbsa_plan(m, k, c, dtype, aligned, 132)
        assert plan.design == design

    def test_design_codes_match_the_kernel_source(self):
        src = (_build.SRC_DIR / "gemm_tiles.cuh").read_text()
        m = re.search(r"enum Design : int \{ kSimt = (\d+), kWmma = (\d+), "
                      r"kWgmma = (\d+) \};", src)
        assert tuple(int(x) for x in m.groups()) == (
            fused.GBSA_DESIGNS["simt"], fused.GBSA_DESIGNS["v1"],
            fused.GBSA_DESIGNS["v2"])


class TestSsaBwdDesign:
    """The design of scale_shift_act's backward kernel
    (`kernels.ssa_bwd_design`): a dispatch by width and alignment."""

    @pytest.mark.parametrize("c", [512, 256, 128, 64])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_celeba64_shapes_take_vector(self, c, dtype):
        assert kernels.ssa_bwd_design(c, dtype, True) == "vector"

    @pytest.mark.parametrize("c, dtype, aligned, design", [
        (72, torch.bfloat16, True, "vector"),
        (60, torch.bfloat16, True, "scalar"),     # not a multiple of 8
        (60, torch.float32, True, "vector"),      # a multiple of 4
        (70, torch.float32, True, "scalar"),
        (72, torch.bfloat16, False, "scalar"),    # a pointer off 16 bytes
        (8, torch.bfloat16, True, "vector"),
        (4, torch.bfloat16, True, "scalar"),
        (2048, torch.bfloat16, True, "vector"),   # 256 threads on a row
        (2056, torch.bfloat16, True, "scalar"),   # 257
        (1024, torch.float32, True, "vector"),
        (1028, torch.float32, True, "scalar")])
    def test_width_and_alignment_pick_the_design(self, c, dtype, aligned,
                                                 design):
        assert kernels.ssa_bwd_design(c, dtype, aligned) == design

    def test_rejects_other_dtypes(self):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernels.ssa_bwd_design(64, torch.float16, True)

    def test_constants_match_the_kernel_source(self):
        src = (_build.SRC_DIR / "scale_shift_act.cu").read_text()
        threads = re.search(r"constexpr int kBwdThreads = (\d+);", src)
        codes = re.search(r"enum BwdDesign : int \{ kBwdScalar = (\d+), "
                          r"kBwdVector = (\d+) \};", src)
        assert int(threads.group(1)) == kernels.SSA_BWD_THREADS
        assert tuple(int(x) for x in codes.groups()) == (
            kernels.SSA_BWD_DESIGNS["scalar"],
            kernels.SSA_BWD_DESIGNS["vector"])


# the eight [N, C] shapes of BN on the celeba64 training step at batch 64:
# G bn0, G deconv1-3, D conv1-3 (bn0 and D conv3 share [1024, 512])
CELEBA64_BN = [(1024, 512), (4096, 256), (16384, 128), (65536, 64),
               (16384, 128), (4096, 256), (1024, 512)]


def _source_const(source, name):
    src = (_build.SRC_DIR / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


class TestSsaFwdDesign:
    """The design of scale_shift_act's forward kernel
    (`kernels.ssa_fwd_design`): a dispatch by width and alignment."""

    @pytest.mark.parametrize("shape", CELEBA64_BN)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_celeba64_shapes_take_vector(self, shape, dtype):
        assert kernels.ssa_fwd_design(shape[1], dtype, True) == "vector"

    @pytest.mark.parametrize("c, dtype, aligned, design", [
        (72, torch.bfloat16, True, "vector"),
        (70, torch.bfloat16, True, "scalar"),     # ragged
        (60, torch.bfloat16, True, "scalar"),     # not a multiple of 8
        (60, torch.float32, True, "vector"),      # a multiple of 4
        (70, torch.float32, True, "scalar"),
        (512, torch.bfloat16, False, "scalar"),   # an operand off 16 bytes
        (64, torch.float32, False, "scalar"),
        (2048, torch.bfloat16, True, "vector"),   # 256 threads on a row
        (2056, torch.bfloat16, True, "scalar"),   # 257
        (1028, torch.float32, True, "scalar")])
    def test_width_and_alignment_pick_the_design(self, c, dtype, aligned,
                                                 design):
        assert kernels.ssa_fwd_design(c, dtype, aligned) == design

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
    def test_rejects_other_dtypes(self, dtype):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernels.ssa_fwd_design(64, dtype, True)

    def test_constants_match_the_kernel_source(self):
        src = (_build.SRC_DIR / "scale_shift_act.cu").read_text()
        codes = re.search(r"enum FwdDesign : int \{ kFwdScalar = (\d+), "
                          r"kFwdVector = (\d+) \};", src)
        assert _source_const("scale_shift_act.cu", "kFwdThreads") == \
            kernels.SSA_FWD_THREADS
        assert tuple(int(x) for x in codes.groups()) == (
            kernels.SSA_FWD_DESIGNS["scalar"],
            kernels.SSA_FWD_DESIGNS["vector"])


class TestMomentsPlan:
    """The plan of channel_moments' kernel (`kernels.moments_plan`): the
    design by width and alignment, the column strips and the clusters per
    strip; pinned on an H100's 132 SMs."""

    # (N, C), then the strips and groups in bf16 and in f32: bn0 (and D
    # conv3) in one cluster per strip, the larger shapes in up to 16
    # clusters per strip (2 CTAs per SM)
    CELEBA64 = [((1024, 512), (4, 1), (8, 1)),
                ((4096, 256), (2, 4), (4, 4)),
                ((16384, 128), (1, 16), (2, 8)),
                ((65536, 64), (1, 16), (1, 16))]

    @pytest.mark.parametrize("shape, bf16, f32", CELEBA64)
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_celeba64_shapes(self, shape, bf16, f32, dtype):
        plan = kernels.moments_plan(*shape, dtype, True, 132)
        want = bf16 if dtype == torch.bfloat16 else f32
        assert plan == kernels.MomentsPlan("vector", *want)
        ctas = plan.strips * plan.groups * kernels.MOMENTS_CLUSTER
        assert ctas <= kernels.MOMENTS_CTAS_PER_SM * 132

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_bn0_is_one_cluster_per_strip(self, dtype):
        """G bn0 at batch 64, the main path's shape: one launch that needs
        no workspace and no ticket."""
        assert kernels.moments_plan(1024, 512, dtype, True, 132).groups == 1

    @pytest.mark.parametrize("n, c, dtype, aligned, plan", [
        (37, 70, torch.bfloat16, True, ("scalar", 3, 1)),    # ragged
        (5, 3, torch.float32, True, ("scalar", 1, 1)),
        (3, 512, torch.bfloat16, True, ("vector", 4, 1)),    # N < a step
        (1024, 60, torch.bfloat16, True, ("scalar", 2, 2)),  # C % 8
        (1024, 60, torch.float32, True, ("vector", 1, 1)),   # C % 4 == 0
        (1024, 512, torch.bfloat16, False, ("scalar", 16, 1)),
        (65536, 64, torch.bfloat16, False, ("scalar", 2, 8)),
        (10 ** 6, 8, torch.bfloat16, True, ("vector", 1, 16)),
        (4096, 72, torch.bfloat16, True, ("vector", 1, 3))])
    def test_width_and_alignment_pick_the_plan(self, n, c, dtype, aligned,
                                               plan):
        assert kernels.moments_plan(n, c, dtype, aligned, 132) == plan

    def test_fewer_sms_cap_the_groups(self):
        assert kernels.moments_plan(65536, 64, torch.bfloat16, True,
                                    32).groups == 4

    @pytest.mark.parametrize("args, err", [
        ((64, 64, torch.float16, True, 132), TypeError),
        ((0, 64, torch.bfloat16, True, 132), ValueError),
        ((64, 64, torch.bfloat16, True, 0), ValueError)])
    def test_bad_arguments_raise(self, args, err):
        with pytest.raises(err):
            kernels.moments_plan(*args)

    def test_constants_match_the_kernel_source(self):
        src = (_build.SRC_DIR / "channel_moments.cu").read_text()
        codes = re.search(r"enum MomentsDesign : int \{ kMomentsScalar = "
                          r"(\d+), kMomentsVector = (\d+) \};", src)
        assert tuple(int(x) for x in codes.groups()) == (
            kernels.MOMENTS_DESIGNS["scalar"],
            kernels.MOMENTS_DESIGNS["vector"])
        assert [_source_const("channel_moments.cu", name) for name in (
            "kThreads", "kCluster", "kStripVector", "kStripScalar",
            "kRowsPerTurn", "kCtasPerSm")] == [
            kernels.MOMENTS_THREADS, kernels.MOMENTS_CLUSTER,
            kernels.MOMENTS_STRIP["vector"], kernels.MOMENTS_STRIP["scalar"],
            kernels.MOMENTS_ROWS_PER_TURN, kernels.MOMENTS_CTAS_PER_SM]


def _assert_sum_close(got, want, terms_abs):
    """A column sum taken in another order: within 1e-5 of the sum of the
    terms' magnitudes (plus 1e-6)."""
    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) else got
    w = want.detach().float().cpu().numpy() if torch.is_tensor(want) \
        else want
    t = terms_abs.detach().float().cpu().numpy() \
        if torch.is_tensor(terms_abs) else terms_abs
    bad = np.abs(g - w) > 1e-5 * t + 1e-6
    assert not bad.any(), (np.abs(g - w).max(), bad.sum())


class TestChannelMomentsPlain:
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("shape", [(24, 40), (7, 13)])
    def test_matches_jax(self, jref, tdt, jname, shape):
        jnp = jref.jnp
        x = _np(70, shape, -2, 2)
        got = kernels.channel_moments(torch.from_numpy(x).to(tdt))
        want = jref.kernels.channel_moments(jnp.asarray(x, jnp.dtype(jname)))
        xr = torch.from_numpy(x).to(tdt).float()
        for g, w, t in zip(got, want, (xr.abs().mean(0),
                                       (xr * xr).mean(0))):
            assert g.dtype == torch.float32 and tuple(g.shape) == shape[1:]
            _assert_sum_close(g, _j2np(jnp, w), t)

    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_vjp_matches_jax(self, jref, tdt, jname):
        """The autograd Function's backward against `_moments_vjp_bwd`:
        f32 1e-5, bf16 one ulp."""
        jax, jnp = jref.jax, jref.jnp
        x = _np(71, (24, 40), -2, 2)
        gm, gq = _np(72, (40,)), _np(73, (40,))
        _, vjp = jax.vjp(jref.kernels.channel_moments,
                         jnp.asarray(x, jnp.dtype(jname)))
        (want,) = vjp((jnp.asarray(gm), jnp.asarray(gq)))
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        (got,) = torch.autograd.grad(
            kernels.channel_moments(tx), tx,
            (torch.from_numpy(gm), torch.from_numpy(gq)))
        assert got.dtype == tdt
        _assert_close(got, _j2np(jnp, want), tdt)


class TestScaleShiftActBackwardPlain:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_matches_jax_vjp(self, jref, act, tdt, jname):
        """`scale_shift_act_bwd` (plain on the CPU) and the autograd
        Function's gradients against jax.vjp of the Pallas kernel (its
        backward is `_ssa_bwd_kernel`): dx f32 1e-5 / bf16 one ulp, dscale
        and dshift as column sums."""
        jax, jnp = jref.jax, jref.jnp
        jdt = jnp.dtype(jname)
        x = _np(80, (24, 40), -2, 2)
        scale, shift = _np(81, (40,), 0.5, 1.5), _np(82, (40,))
        g = _np(83, (24, 40))
        _, vjp = jax.vjp(
            lambda a, s, t: jref.kernels.scale_shift_act(a, s, t, act),
            jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(shift))
        want = [_j2np(jnp, v) for v in vjp(jnp.asarray(g, jdt))]
        tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
        ts, tt = torch.from_numpy(scale), torch.from_numpy(shift)
        xa, ga = tx.float().abs(), tg.float().abs()
        bounds = (None, (ga * xa).sum(0), ga.sum(0))

        direct = kernels.scale_shift_act_bwd(tx, ts, tt, tg, act)
        leaves = [t.clone().requires_grad_(True) for t in (tx, ts, tt)]
        via_autograd = torch.autograd.grad(
            kernels.scale_shift_act(*leaves, act), leaves, tg)
        for got in (direct, via_autograd):
            assert got[0].dtype == tdt
            _assert_close(got[0], want[0], tdt)
            for i in (1, 2):
                _assert_sum_close(got[i], want[i], bounds[i])


class TestGemmBiasMomentsPlain:
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (64, 96, 16)])
    def test_matches_jax(self, jref, tdt, jname, mkc):
        """u (f32) to 1e-5; the moments of u in the compute dtype as
        column sums, plus in bf16 one ulp of max|u| over M (a u that
        rounds to the neighbouring bf16 value moves one term by an ulp)."""
        jnp = jref.jnp
        m, k, c = mkc
        jdt = jnp.dtype(jname)
        p, w = _np(90, (m, k)), _np(91, (k, c), -0.3, 0.3)
        b = _np(92, (c,))
        got = fused.gemm_bias_moments(torch.from_numpy(p).to(tdt),
                                      torch.from_numpy(w).to(tdt),
                                      torch.from_numpy(b), tdt)
        want = [_j2np(jnp, v) for v in jref.fused.gemm_bias_moments(
            jnp.asarray(p, jdt), jnp.asarray(w, jdt), jnp.asarray(b), jdt)]
        assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (m, c)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-5,
                                   atol=1e-5)
        v = got[0].to(tdt).float()
        flip = BF16_ULP * float(v.abs().max()) / m \
            if tdt == torch.bfloat16 else 0.0
        for g, wnt, t in zip(got[1:], want[1:], (v.abs().mean(0),
                                                (v * v).mean(0))):
            _assert_sum_close(g, wnt, t + 2 * flip * (1 + v.abs().max()))

    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_vjp_matches_jax(self, jref, tdt, jname):
        """The autograd Function's backward against `_gbm_vjp_bwd`: dp and
        dw in the operands' dtype (f32 1e-5, bf16 one ulp), db f32."""
        jax, jnp = jref.jax, jref.jnp
        jdt = jnp.dtype(jname)
        m, k, c = 40, 24, 12
        p, w = _np(93, (m, k)), _np(94, (k, c), -0.3, 0.3)
        b = _np(95, (c,))
        gu, gm, gq = _np(96, (m, c)), _np(97, (c,)), _np(98, (c,))
        _, vjp = jax.vjp(
            lambda a, bb, cc: jref.fused.gemm_bias_moments(a, bb, cc, jdt),
            jnp.asarray(p, jdt), jnp.asarray(w, jdt), jnp.asarray(b))
        want = [_j2np(jnp, v) for v in vjp(
            (jnp.asarray(gu), jnp.asarray(gm), jnp.asarray(gq)))]
        leaves = [torch.from_numpy(p).to(tdt).requires_grad_(True),
                  torch.from_numpy(w).to(tdt).requires_grad_(True),
                  torch.from_numpy(b).requires_grad_(True)]
        got = torch.autograd.grad(
            fused.gemm_bias_moments(*leaves, tdt), leaves,
            tuple(torch.from_numpy(a) for a in (gu, gm, gq)))
        assert [g.dtype for g in got] == [tdt, tdt, torch.float32]
        for i in (0, 1):
            _assert_close(got[i], want[i], tdt)
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("transpose,act", [(True, "relu"),
                                               (False, "lrelu")])
    @pytest.mark.parametrize("tdt,jname", DTYPES)
    def test_fused_train_stage_matches_jax(self, jref, transpose, act, tdt,
                                           jname):
        _check_fused_train_stage(jref, transpose=transpose, act=act,
                                 tdt=tdt, jname=jname)

    def test_cpu_takes_plain_version_without_counting(self):
        before = fused.gemm_bias_moments.launches
        p, w = torch.ones(6, 4), torch.ones(4, 3)
        u, mean, mean_sq = fused.gemm_bias_moments(p, w, torch.zeros(3))
        assert fused.gemm_bias_moments.launches == before
        torch.testing.assert_close(u, torch.full((6, 3), 4.0))
        torch.testing.assert_close(mean_sq, torch.full((3,), 16.0))


def _check_fused_train_stage(jref, *, transpose, act, tdt, jname):
    """fused_conv_bn_act(train=True) against JAX: the output (f32 1e-5,
    bf16 two ulps of the output's scale), the new BN state (1e-5 in f32;
    bf16 moments of rounded activations, 1e-3) and the gradients of every
    input under a random cotangent (f32: sums through BN's backward in
    another order, rtol 1e-4 atol 5e-5 — b's gradient is 0 in exact
    arithmetic, BN removing the bias, so both sides are the rounding noise
    of sums of O(100) terms of O(1); bf16: 2e-2 of each gradient's
    scale)."""
    jax, jnp = jref.jax, jref.jnp
    jdt = jnp.dtype(jname)
    cin, cout = 6, 10
    x = _np(60, (2, 4, 4, cin) if transpose else (2, 8, 8, cin), 0, 1)
    w, b = _np(61, (5, 5, cin, cout), -0.1, 0.1), _np(62, (cout,), -0.1, 0.1)
    gamma, beta = _np(63, (cout,), 0.5, 1.5), _np(64, (cout,))
    mean, var = _np(65, (cout,), -0.2, 0.2), _np(66, (cout,), 0.5, 1.5)
    out_hw = 8 if transpose else 4
    g = _np(67, (2, out_hw, out_hw, cout))

    def jf(x_, w_, b_, gamma_, beta_):
        return jref.fused.fused_conv_bn_act(
            {"w": w_, "b": b_}, {"scale": gamma_, "bias": beta_},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}, x_,
            transpose=transpose, kernel=5, train=True, momentum=0.9,
            act=act, compute_dtype=jdt)

    jy, vjp, jstate = jax.vjp(jf, *(jnp.asarray(a) for a in (
        x, w, b, gamma, beta)), has_aux=True)
    jgrads = vjp(jnp.asarray(g, jy.dtype))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w, b, gamma, beta)]
    ty, tstate = fused.fused_conv_bn_act(
        {"w": leaves[1], "b": leaves[2]},
        {"scale": leaves[3], "bias": leaves[4]},
        {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
        leaves[0], transpose=transpose, kernel=5, train=True, momentum=0.9,
        act=act, compute_dtype=tdt)
    assert ty.dtype == tdt and tuple(ty.shape) == tuple(jy.shape)
    tgrads = torch.autograd.grad(ty, leaves, torch.from_numpy(g).to(tdt))
    yw = _j2np(jnp, jy)
    if tdt == torch.float32:
        np.testing.assert_allclose(ty.detach().numpy(), yw, rtol=1e-5,
                                   atol=1e-5)
        stol = 1e-5
    else:
        err = np.abs(ty.detach().float().numpy() - yw).max()
        assert err <= 2 * BF16_ULP * np.abs(yw).max(), err
        stol = 1e-3
    for key in ("mean", "var"):
        assert not tstate[key].requires_grad
        np.testing.assert_allclose(tstate[key].numpy(),
                                   _j2np(jnp, jstate[key]), rtol=stol,
                                   atol=stol)
    for got, want in zip(tgrads, jgrads):
        wn = _j2np(jnp, want)
        assert tuple(got.shape) == wn.shape
        if tdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), wn, rtol=1e-4,
                                       atol=5e-5)
        else:
            err = np.abs(got.float().numpy() - wn).max()
            assert err <= 2e-2 * max(np.abs(wn).max(), 1e-3), err


# ---------------------------------------------------------------------------
# The build's ptxas report, as chip_smoke reads it
# ---------------------------------------------------------------------------

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelILi16ELi32EEEvPK13__nv_bfloat16S3_S3_PfS4_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelILi16ELi32EEEvPK13__nv_bfloat16S3_S3_PfS4_iiifi
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_dq_kernelI13__nv_bfloat16Li16ELi32EEEvPKT_S4_S4_S4_PKfS6_PS2_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_dq_kernelI13__nv_bfloat16Li16ELi32EEEvPKT_S4_S4_S4_PKfS6_PS2_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5dcgan22finish_column_partialsEPKfiifPfS2_' for 'sm_90a'
ptxas info    : Used 32 registers, 392 bytes cmem[0]
"""


class TestPtxasReport:
    @pytest.mark.parametrize("text, want", [
        (PTXAS_LOG, [
            {"entry": "_ZN12_GLOBAL__N_116flash_fwd_kernelILi16ELi32EEEvPK13"
                      "__nv_bfloat16S3_S3_PfS4_iiifi",
             "stack": 8, "spill_stores": 8, "spill_loads": 12,
             "registers": 128},
            {"entry": "_ZN12_GLOBAL__N_115flash_dq_kernelI13__nv_bfloat16Li16"
                      "ELi32EEEvPKT_S4_S4_S4_PKfS6_PS2_iiif",
             "stack": 0, "spill_stores": 0, "spill_loads": 0,
             "registers": 94},
            {"entry": "_ZN5dcgan22finish_column_partialsEPKfiifPfS2_",
             "registers": 32}]),
        ("", []),
        # lines before the first entry belong to no kernel
        ("ptxas info    : Used 12 registers\n"
         "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n",
         [{"entry": "k"}]),
        ("ptxas info    : Compiling entry function 'a' for 'sm_90a'\n"
         "ptxas info    : Compiling entry function 'b' for 'sm_90a'\n"
         "ptxas info    : Used 7 registers, 384 bytes cmem[0]\n",
         [{"entry": "a"}, {"entry": "b", "registers": 7}])])
    def test_names_each_entry_with_its_registers_and_spills(self, text,
                                                            want):
        assert _build.ptxas_report(text) == want


SASS_DUMP = """\
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN12_GLOBAL__N_117gbsa_wgmma_kernelILi256E13__nv_bfloat16EEvN
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
        /*0090*/                   UTMALDG.2D [UR8], [UR4] ;              /* 0x00000008040075b4 */
        /*00a0*/              @!P0 UTMALDG.2D [UR16], [UR4] ;             /* 0x00000010040085b4 */
        /*00b0*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*00c0*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR8], R24 ;
		Function : _ZN12_GLOBAL__N_115flash_dq_kernelILi16ELi32EEEvPK13__nv_bfloat16
        /*0010*/                   MUFU.RCP R2, R3 ;
        /*0020*/               @P1 MUFU.EX2 R2, R3 ;
        /*0030*/                   MUFU.EX2 R5, R6 ;
        /*0040*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0050*/             @!UPT LDSM.16.MT88.2 R8, [R2+0x200] ;
        /*0060*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
"""

OPCODES = ["HGMMA", "UTMALDG", "LDSM", "MUFU.EX2", "HMMA"]


class TestSassCounts:
    """`_build.sass_counts`, which chip_smoke runs on `cuobjdump -sass`
    of the built libraries to show the redesigned kernels use wgmma, TMA,
    ldmatrix and the ex2 unit."""

    @pytest.mark.parametrize("text, want", [
        (SASS_DUMP, {
            "_ZN12_GLOBAL__N_117gbsa_wgmma_kernelILi256E13__nv_bfloat16EEvN":
                {"HGMMA": 2, "UTMALDG": 2, "LDSM": 0, "MUFU.EX2": 0,
                 "HMMA": 0},
            "_ZN12_GLOBAL__N_115flash_dq_kernelILi16ELi32EEEvPK13"
            "__nv_bfloat16":
                {"HGMMA": 0, "UTMALDG": 0, "LDSM": 2, "MUFU.EX2": 2,
                 "HMMA": 1}}),
        ("", {}),
        # instructions before the first function belong to none
        ("        /*0000*/  HGMMA.64x64x16.F32.BF16 R0, gdesc[UR4], R0 ;\n",
         {}),
        # a function with none of the opcodes still has its zeros
        ("\t\tFunction : k\n        /*0000*/   EXIT ;\n",
         {"k": dict.fromkeys(OPCODES, 0)})])
    def test_counts_each_opcode_per_function(self, text, want):
        assert _build.sass_counts(text, OPCODES) == want

    def test_modifiers_do_not_match_other_opcodes(self):
        """MUFU.EX2 counts only the ex2 op; LDSM does not count LDS."""
        text = ("\t\tFunction : f\n"
                "        /*0000*/   MUFU.EX2 R0, R1 ;\n"
                "        /*0010*/   MUFU.EX2.F16 R0, R1 ;\n"
                "        /*0020*/   MUFU.RSQ R0, R1 ;\n"
                "        /*0030*/   LDS.128 R0, [R1] ;\n"
                "        /*0040*/   LDSM.16.M88.4 R0, [R1] ;\n")
        assert _build.sass_counts(text, ["MUFU.EX2", "LDSM"]) == {
            "f": {"MUFU.EX2": 2, "LDSM": 1}}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, same tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(1024, 512), (37, 70), (5, 3)])
    def test_scale_shift_act(self, cuda, act, tdt, shape):
        x = torch.from_numpy(_np(30, shape, -2, 2)).to(cuda, tdt)
        scale = torch.from_numpy(_np(31, shape[1:], 0.5, 1.5)).to(cuda)
        shift = torch.from_numpy(_np(32, shape[1:])).to(cuda)
        before = kernels.scale_shift_act.launches
        got = kernels.scale_shift_act(x, scale, shift, act)
        torch.cuda.synchronize()
        assert kernels.scale_shift_act.launches == before + 1
        _assert_close(got, kernels.scale_shift_act_plain(x, scale, shift,
                                                         act), tdt)

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (100, 40, 72),
                                     (300, 800, 256), (1024, 3200, 64),
                                     (64, 12800, 256), (200, 3000, 40)])
    def test_gemm_bias_scale_act(self, cuda, act, tdt, mkc):
        m, k, c = mkc
        p = torch.from_numpy(_np(40, (m, k))).to(cuda, tdt)
        w = torch.from_numpy(_np(41, (k, c), -0.05, 0.05)).to(cuda, tdt)
        b, scale, shift = (torch.from_numpy(a).to(cuda) for a in (
            _np(42, (c,)), _np(43, (c,), 0.5, 1.5), _np(44, (c,))))
        before = fused.gemm_bias_scale_act.launches
        got = fused.gemm_bias_scale_act(p, w, b, scale, shift, act,
                                        out_dtype=tdt)
        torch.cuda.synchronize()
        assert fused.gemm_bias_scale_act.launches == before + 1
        want = fused.gemm_bias_scale_act_plain(p, w, b, scale, shift, act,
                                               out_dtype=tdt)
        g, wnt = got.float(), want.float()
        # f32 sums of <= 12800 products in another order (split-K for the
        # small-M bf16 cases): 1e-4 absolute
        tol = BF16_ULP * wnt.abs() + 1e-4 if tdt == torch.bfloat16 \
            else 1e-5 * wnt.abs() + 1e-4
        assert bool(((g - wnt).abs() <= tol).all())

    # (M, K, C, pointer offset in elements, the design gbsa_plan picks):
    # celeba64's three stages at batch 2, an aligned ragged shape, then
    # K 37 / C 70 and the aligned shape off 16-byte alignment, both on v1
    GBSA_CASES = [(128, 12800, 256, 0, "v2"), (512, 6400, 128, 0, "v2"),
                  (2048, 3200, 64, 0, "v2"), (1000, 200, 72, 0, "v2"),
                  (100, 37, 70, 0, "v1"), (1000, 200, 72, 1, "v1")]

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("out_dt", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("case", GBSA_CASES)
    def test_gemm_bias_scale_act_designs(self, cuda, act, out_dt, case):
        """bf16 operands on each design gbsa_plan picks: the launch takes
        that design, matches the plain version and repeats bit for bit."""
        m, k, c, offset, design = case
        p = _at_offset(torch.from_numpy(_np(45, (m, k))).to(
            cuda, torch.bfloat16), offset)
        w = _at_offset(torch.from_numpy(_np(46, (k, c), -0.05, 0.05)).to(
            cuda, torch.bfloat16), offset)
        b, scale, shift = (torch.from_numpy(a).to(cuda) for a in (
            _np(47, (c,)), _np(48, (c,), 0.5, 1.5), _np(49, (c,))))
        by_design = fused.gemm_bias_scale_act.launches_by_design
        before = dict(by_design)
        got = fused.gemm_bias_scale_act(p, w, b, scale, shift, act,
                                        out_dtype=out_dt)
        again = fused.gemm_bias_scale_act(p, w, b, scale, shift, act,
                                          out_dtype=out_dt)
        torch.cuda.synchronize()
        assert by_design == dict(before, **{design: before[design] + 2})
        assert torch.equal(got, again), "two launches differ"
        want = fused.gemm_bias_scale_act_plain(p, w, b, scale, shift, act,
                                               out_dtype=out_dt)
        g, wnt = got.float(), want.float()
        # as test_gemm_bias_scale_act: f32 sums in another order
        tol = BF16_ULP * wnt.abs() + 1e-4 if out_dt == torch.bfloat16 \
            else 1e-5 * wnt.abs() + 1e-4
        assert bool(((g - wnt).abs() <= tol).all())

    def test_bf16_operands_f32_output(self, cuda):
        p = torch.from_numpy(_np(50, (64, 48))).to(cuda, torch.bfloat16)
        w = torch.from_numpy(_np(51, (48, 16), -0.1, 0.1)).to(
            cuda, torch.bfloat16)
        v = torch.ones(16, device=cuda)
        got = fused.gemm_bias_scale_act(p, w, 0 * v, v, 0 * v, "none",
                                        out_dtype=torch.float32)
        want = fused.gemm_bias_scale_act_plain(p, w, 0 * v, v, 0 * v, "none",
                                               out_dtype=torch.float32)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def test_wrappers_raise_instead_of_falling_back(self, cuda,
                                                    monkeypatch):
        x = torch.zeros(8, 6, device=cuda).t()   # not contiguous
        with pytest.raises(ValueError, match="contiguous"):
            kernels.scale_shift_act(x, torch.ones(8, device=cuda),
                                    torch.zeros(8, device=cuda))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kernels.scale_shift_act(torch.zeros(4, 4, device=cuda,
                                                dtype=torch.float16),
                                    torch.ones(4, device=cuda),
                                    torch.zeros(4, device=cuda))
        with pytest.raises(ValueError, match="is on"):
            fused.gemm_bias_scale_act(torch.zeros(4, 4, device=cuda),
                                      torch.zeros(4, 2, device=cuda),
                                      torch.zeros(2), torch.zeros(2),
                                      torch.zeros(2))
        # a plan the kernel cannot run is refused by the launch and raises;
        # no other design or plain torch takes over
        p = torch.zeros(256, 64, device=cuda, dtype=torch.bfloat16)
        w = torch.zeros(64, 64, device=cuda, dtype=torch.bfloat16)
        v = torch.zeros(64, device=cuda)
        plan = fused.gbsa_plan
        for bad in ({"stages": 1}, {"bm": 64}, {"design": "simt"}):
            with monkeypatch.context() as patch:
                patch.setattr(fused, "gbsa_plan", lambda *a, bad=bad:
                              plan(*a)._replace(**bad))
                count = fused.gemm_bias_scale_act.launches
                with pytest.raises(RuntimeError, match="launch failed"):
                    fused.gemm_bias_scale_act(p, w, v, v, v)
                assert fused.gemm_bias_scale_act.launches == count
        # the same for gemm_bias_moments' plan, and for a backward design
        # that does not fit its operands
        plan = fused.gemm_plan
        for bad in ({"stages": 1}, {"bm": 64}, {"bn": 128},
                    {"design": "simt"}):
            with monkeypatch.context() as patch:
                patch.setattr(fused, "gemm_plan", lambda *a, bad=bad:
                              plan(*a)._replace(**bad))
                count = fused.gemm_bias_moments.launches
                with pytest.raises(RuntimeError, match="launch failed"):
                    fused.gemm_bias_moments(p, w, v, torch.bfloat16)
                assert fused.gemm_bias_moments.launches == count
        x = _at_offset(torch.zeros(16, 64, device=cuda,
                                   dtype=torch.bfloat16), 1)
        with monkeypatch.context() as patch:
            patch.setattr(kernels, "ssa_bwd_design", lambda *a: "vector")
            count = kernels.scale_shift_act_bwd.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                kernels.scale_shift_act_bwd(x, v, v, x)
            assert kernels.scale_shift_act_bwd.launches == count
        # the same for the forward's vector design and the moments' vector
        # plan on that unaligned pointer
        with monkeypatch.context() as patch:
            patch.setattr(kernels, "ssa_fwd_design", lambda *a: "vector")
            count = kernels.scale_shift_act.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                kernels.scale_shift_act(x, v, v)
            assert kernels.scale_shift_act.launches == count
        plan = kernels.moments_plan
        with monkeypatch.context() as patch:
            patch.setattr(kernels, "moments_plan", lambda *a: plan(
                *a)._replace(design="vector"))
            count = kernels.channel_moments.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                kernels.channel_moments(x)
            assert kernels.channel_moments.launches == count
        # and a moments plan whose column strips differ from the build's
        x = torch.zeros(64, 512, device=cuda, dtype=torch.bfloat16)
        with monkeypatch.context() as patch:
            patch.setattr(kernels, "moments_plan", lambda *a: plan(
                *a)._replace(strips=plan(*a).strips * 2))
            count = kernels.channel_moments.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                kernels.channel_moments(x)
            assert kernels.channel_moments.launches == count
        # the bf16 dq kernel's wrapper raises on what it does not take
        q = torch.zeros((1, 8, 8), device=cuda, dtype=torch.bfloat16)
        lse = torch.zeros((1, 8), device=cuda)
        with pytest.raises(ValueError, match="do must be"):
            flash.flash_dq(q, q, q, q.float(), lse, lse, 1.0)
        with pytest.raises(ValueError, match="d_qk"):
            wide = torch.zeros((1, 8, 65), device=cuda, dtype=torch.bfloat16)
            flash.flash_dq(wide, wide, q, q, lse, lse, 1.0)

    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(1024, 512), (37, 70), (5, 3),
                                       (65536, 64)])
    def test_channel_moments(self, cuda, tdt, shape):
        """Kernel 1 against its plain version (column sums), and two
        launches on the same input give the same bits."""
        x = torch.from_numpy(_np(100, shape, -2, 2)).to(cuda, tdt)
        before = kernels.channel_moments.launches
        got = kernels.channel_moments(x)
        again = kernels.channel_moments(x)
        torch.cuda.synchronize()
        assert kernels.channel_moments.launches == before + 2
        xf = x.float()
        for g, a, w, t in zip(got, again, kernels.channel_moments_plain(x),
                              (xf.abs().mean(0), (xf * xf).mean(0))):
            assert torch.equal(g, a)
            _assert_sum_close(g, w, t)

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shape", [(1024, 512), (37, 70), (5, 3),
                                       (4096, 256)])
    def test_scale_shift_act_bwd(self, cuda, act, tdt, shape):
        """Kernel 3 against its plain version: dx elementwise, dscale and
        dshift as column sums; bitwise repeat."""
        x = torch.from_numpy(_np(110, shape, -2, 2)).to(cuda, tdt)
        g = torch.from_numpy(_np(111, shape)).to(cuda, tdt)
        scale = torch.from_numpy(_np(112, shape[1:], 0.5, 1.5)).to(cuda)
        shift = torch.from_numpy(_np(113, shape[1:])).to(cuda)
        before = kernels.scale_shift_act_bwd.launches
        got = kernels.scale_shift_act_bwd(x, scale, shift, g, act)
        again = kernels.scale_shift_act_bwd(x, scale, shift, g, act)
        torch.cuda.synchronize()
        assert kernels.scale_shift_act_bwd.launches == before + 2
        want = kernels.scale_shift_act_bwd_plain(x, scale, shift, g, act)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert got[0].dtype == tdt
        _assert_close(got[0], want[0], tdt)
        ga, xa = g.float().abs(), x.float().abs()
        _assert_sum_close(got[1], want[1], (ga * xa).sum(0))
        _assert_sum_close(got[2], want[2], ga.sum(0))

    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("mkc", [(37, 29, 11), (100, 40, 72),
                                     (300, 800, 256), (1024, 6400, 512),
                                     (4096, 12800, 256), (200, 3000, 40)])
    def test_gemm_bias_moments(self, cuda, tdt, mkc):
        """Kernel 4: u against the plain product (f32 sums of up to 12800
        products in another order, split-K at the small-M bf16 shapes:
        1e-5 relative + 1e-4), the moments against those of the kernel's
        own u in the compute dtype (column sums); bitwise repeat."""
        m, k, c = mkc
        p = torch.from_numpy(_np(120, (m, k))).to(cuda, tdt)
        w = torch.from_numpy(_np(121, (k, c), -0.05, 0.05)).to(cuda, tdt)
        b = torch.from_numpy(_np(122, (c,))).to(cuda)
        before = fused.gemm_bias_moments.launches
        got = fused.gemm_bias_moments(p, w, b, tdt)
        again = fused.gemm_bias_moments(p, w, b, tdt)
        torch.cuda.synchronize()
        assert fused.gemm_bias_moments.launches == before + 2
        assert all(torch.equal(a, bb) for a, bb in zip(got, again))
        u_want = fused.gemm_bias_moments_plain(p, w, b, tdt)[0]
        assert bool(((got[0] - u_want).abs()
                     <= 1e-5 * u_want.abs() + 1e-4).all())
        v = got[0].to(tdt).float()
        _assert_sum_close(got[1], v.mean(0), v.abs().mean(0))
        _assert_sum_close(got[2], (v * v).mean(0), (v * v).mean(0))

    @staticmethod
    def _check_gbm(p, w, b, tdt, design):
        """Kernel 4 twice: the design taken, the same bits, u against the
        plain product (as test_gemm_bias_moments) and the moments against
        those of the kernel's own u in the compute dtype."""
        by_design = fused.gemm_bias_moments.launches_by_design
        before = dict(by_design)
        got = fused.gemm_bias_moments(p, w, b, tdt)
        again = fused.gemm_bias_moments(p, w, b, tdt)
        torch.cuda.synchronize()
        assert by_design == dict(before, **{design: before[design] + 2})
        assert all(torch.equal(a, bb) for a, bb in zip(got, again))
        u_want = fused.gemm_bias_moments_plain(p, w, b, tdt)[0]
        assert bool(((got[0] - u_want).abs()
                     <= 1e-5 * u_want.abs() + 1e-4).all())
        v = got[0].to(tdt).float()
        _assert_sum_close(got[1], v.mean(0), v.abs().mean(0))
        _assert_sum_close(got[2], (v * v).mean(0), (v * v).mean(0))

    @pytest.mark.parametrize("m, k, c, bn, splits", TestGbmPlan.CELEBA64)
    def test_gemm_bias_moments_v2_at_celeba64_stages(self, cuda, m, k, c, bn,
                                                     splits):
        """Kernel 4 at each celeba64 training stage's shape at batch 64, on
        the plan TestGbmPlan pins (v2, its column tile and splits)."""
        g = torch.Generator(device=cuda).manual_seed(m + k + c)
        p = (torch.rand((m, k), generator=g, device=cuda) * 2 - 1).to(
            torch.bfloat16)
        w = ((torch.rand((k, c), generator=g, device=cuda) - 0.5) * 0.1).to(
            torch.bfloat16)
        b = torch.rand(c, generator=g, device=cuda) * 2 - 1
        plan = fused.gemm_plan(p, w, kernels.sm_count(cuda))
        if kernels.sm_count(cuda) == 132:
            assert (plan.design, plan.bn, plan.splits) == ("v2", bn, splits)
        assert plan.design == "v2"
        self._check_gbm(p, w, b, torch.bfloat16, "v2")

    # (M, K, C, pointer offset in elements, the design gemm_plan picks): a
    # ragged aligned shape and a 40-column one on v2, then K 37 / C 70 and
    # aligned shapes off 16-byte alignment (one split-K) on v1
    GBM_CASES = [(1000, 200, 72, 0, "v2"), (200, 3000, 40, 0, "v2"),
                 (100, 37, 70, 0, "v1"), (1000, 200, 72, 1, "v1"),
                 (4096, 3200, 256, 1, "v1")]

    @pytest.mark.parametrize("case", GBM_CASES)
    def test_gemm_bias_moments_designs(self, cuda, case):
        """bf16 operands on each design the plan picks: the launch takes
        that design, matches the plain version and repeats bit for bit."""
        m, k, c, offset, design = case
        p = _at_offset(torch.from_numpy(_np(123, (m, k))).to(
            cuda, torch.bfloat16), offset)
        w = _at_offset(torch.from_numpy(_np(124, (k, c), -0.05, 0.05)).to(
            cuda, torch.bfloat16), offset)
        b = torch.from_numpy(_np(125, (c,))).to(cuda)
        assert fused.gemm_plan(p, w, kernels.sm_count(cuda)).design == design
        self._check_gbm(p, w, b, torch.bfloat16, design)

    # (dtype, C, pointer offset in elements, the design ssa_bwd_design
    # picks): C 72 and 60 in bf16 and f32, and C 72 one element off 16-byte
    # alignment
    SSA_BWD_CASES = [(torch.bfloat16, 72, 0, "vector"),
                     (torch.bfloat16, 60, 0, "scalar"),
                     (torch.bfloat16, 72, 1, "scalar"),
                     (torch.float32, 72, 0, "vector"),
                     (torch.float32, 60, 0, "vector"),
                     (torch.float32, 72, 1, "scalar")]

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("case", SSA_BWD_CASES)
    def test_scale_shift_act_bwd_designs(self, cuda, act, case):
        """Kernel 3 on each design, launched 20 times: the design taken
        each time, every launch the same bits as the first (a last-block
        ticket left unreset would change the sums), the plain version
        matched."""
        tdt, c, offset, design = case
        shape = (4099, c)
        x = _at_offset(torch.from_numpy(_np(114, shape, -2, 2)).to(cuda, tdt),
                       offset)
        g = _at_offset(torch.from_numpy(_np(115, shape)).to(cuda, tdt),
                       offset)
        scale = torch.from_numpy(_np(116, (c,), 0.5, 1.5)).to(cuda)
        shift = torch.from_numpy(_np(117, (c,))).to(cuda)
        by_design = kernels.scale_shift_act_bwd.launches_by_design
        before = dict(by_design)
        runs = [kernels.scale_shift_act_bwd(x, scale, shift, g, act)
                for _ in range(20)]
        torch.cuda.synchronize()
        assert by_design == dict(before, **{design: before[design] + 20})
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
        got = runs[0]
        want = kernels.scale_shift_act_bwd_plain(x, scale, shift, g, act)
        _assert_close(got[0], want[0], tdt)
        ga, xa = g.float().abs(), x.float().abs()
        _assert_sum_close(got[1], want[1], (ga * xa).sum(0))
        _assert_sum_close(got[2], want[2], ga.sum(0))

    # (dtype, N, C, pointer offset in elements, the design ssa_fwd_design
    # picks): G deconv3's width with a ragged last turn, N below one
    # block's step of rows, C 60 (a multiple of 4, not of 8), C 72, and
    # operands 2 elements off 16-byte alignment
    SSA_FWD_CASES = [(torch.bfloat16, 4099, 64, 0, "vector"),
                     (torch.bfloat16, 3, 512, 0, "vector"),
                     (torch.bfloat16, 1000, 60, 0, "scalar"),
                     (torch.bfloat16, 1000, 72, 0, "vector"),
                     (torch.bfloat16, 1000, 512, 2, "scalar"),
                     (torch.float32, 4099, 64, 0, "vector"),
                     (torch.float32, 1, 512, 0, "vector"),
                     (torch.float32, 1000, 60, 0, "vector"),
                     (torch.float32, 1000, 70, 0, "scalar"),
                     (torch.float32, 1000, 512, 2, "scalar")]

    @pytest.mark.parametrize("act", ACT_LIST)
    @pytest.mark.parametrize("case", SSA_FWD_CASES)
    def test_scale_shift_act_designs(self, cuda, act, case):
        """Kernel 2 on each design its plan picks: the design taken, and
        the plain version matched."""
        tdt, n, c, offset, design = case
        x = _at_offset(torch.from_numpy(_np(33, (n, c), -2, 2)).to(cuda, tdt),
                       offset)
        scale = torch.from_numpy(_np(34, (c,), 0.5, 1.5)).to(cuda)
        shift = torch.from_numpy(_np(35, (c,))).to(cuda)
        by_design = kernels.scale_shift_act.launches_by_design
        before = dict(by_design)
        got = kernels.scale_shift_act(x, scale, shift, act)
        torch.cuda.synchronize()
        assert by_design == dict(before, **{design: before[design] + 1})
        _assert_close(got, kernels.scale_shift_act_plain(x, scale, shift,
                                                         act), tdt)

    # (dtype, N, C, pointer offset in elements): the plan's design and
    # groups follow from them (TestMomentsPlan); two groups and more take
    # the last-cluster finish
    MOMENTS_CASES = [(torch.bfloat16, 1024, 512, 0),
                     (torch.bfloat16, 3, 512, 0),
                     (torch.bfloat16, 4096, 256, 0),
                     (torch.bfloat16, 65536, 64, 0),
                     (torch.bfloat16, 1000, 60, 0),
                     (torch.bfloat16, 1024, 512, 2),
                     (torch.bfloat16, 65536, 64, 1),
                     (torch.float32, 1024, 60, 0),
                     (torch.float32, 16384, 128, 0),
                     (torch.float32, 37, 70, 0),
                     (torch.float32, 5000, 72, 1)]

    @pytest.mark.parametrize("case", MOMENTS_CASES)
    def test_channel_moments_designs(self, cuda, case):
        """Kernel 1 on each plan, launched 10 times: the design taken each
        time, every launch the same bits as the first (a ticket left
        unreset would change the sums), the plain version matched."""
        tdt, n, c, offset = case
        x = _at_offset(torch.from_numpy(_np(101, (n, c), -2, 2)).to(cuda, tdt),
                       offset)
        plan = kernels.moments_plan(n, c, tdt, x.data_ptr() % 16 == 0,
                                    kernels.sm_count(cuda))
        by_design = kernels.channel_moments.launches_by_design
        before = dict(by_design)
        runs = [kernels.channel_moments(x) for _ in range(10)]
        torch.cuda.synchronize()
        assert by_design == dict(before, **{plan.design:
                                            before[plan.design] + 10})
        for run in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
        xf = x.float()
        for g, w, t in zip(runs[0], kernels.channel_moments_plain(x),
                           (xf.abs().mean(0), (xf * xf).mean(0))):
            _assert_sum_close(g, w, t)

    @pytest.mark.parametrize("transpose,act", [(True, "relu"),
                                               (False, "lrelu")])
    def test_fused_train_stage_matches_cpu(self, cuda, transpose, act):
        """fused_conv_bn_act(train=True) on the card (kernels 4 and 2
        forward, 3 backward) against the same call on the CPU (plain
        versions), f32: output and state 1e-5, gradients rtol 1e-4 atol
        5e-5 (see _check_fused_train_stage)."""
        x = _np(130, (4, 8, 8, 16) if transpose else (4, 16, 16, 16), 0, 1)
        arrays = (x, _np(131, (5, 5, 16, 32), -0.1, 0.1),
                  _np(132, (32,), -0.1, 0.1), _np(133, (32,), 0.5, 1.5),
                  _np(134, (32,)))
        g = _np(135, (4, 16, 16, 32) if transpose else (4, 8, 8, 32))
        results = []
        for dev in ("cpu", cuda):
            leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                      for a in arrays]
            y, state = fused.fused_conv_bn_act(
                {"w": leaves[1], "b": leaves[2]},
                {"scale": leaves[3], "bias": leaves[4]},
                {"mean": torch.zeros(32, device=dev),
                 "var": torch.ones(32, device=dev)}, leaves[0],
                transpose=transpose, kernel=5, train=True, act=act,
                compute_dtype=torch.float32)
            grads = torch.autograd.grad(y, leaves,
                                        torch.from_numpy(g).to(dev))
            results.append([t.detach().cpu() for t in (
                y, state["mean"], state["var"], *grads)])
        for i, (a, b) in enumerate(zip(*results)):
            tol = (1e-5, 1e-5) if i < 3 else (1e-4, 5e-5)
            torch.testing.assert_close(b, a, rtol=tol[0], atol=tol[1])


# ---------------------------------------------------------------------------
# flash attention on the card
# ---------------------------------------------------------------------------

def _assert_flash_close(name, got, want, bound, tdt):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all()), name
    if tdt == torch.bfloat16 and got.dtype == torch.bfloat16:
        bound = bound + BF16_ULP * w.abs()
    bad = (g - w).abs() > bound
    assert not bool(bad.any()), \
        f"{name}: {int(bad.sum())} elements beyond the bound, max |err| " \
        f"{float((g - w).abs().max()):.3g}"


def _at_offset(t, offset):
    """A contiguous copy of t that starts `offset` elements into its own
    buffer (t itself for offset 0)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
class TestFlashOnCard:
    """Kernels 6-8 (csrc/flash_attention.cu) against their plain versions
    on the card: sagan64's shape (B 64, S 1024, d_qk 8, d_v 32), ragged S
    and each head-width instantiation, bf16 and f32, launched twice to show
    the bits repeat. Bounds: `flash_attention.kernel_error_bounds` (plus
    one bf16 ulp of bf16 outputs); lse within 1e-5 (1 + |lse|)."""

    # (B, S, d_qk, d_v): one per head-width instantiation (d_qk padded to
    # 16 or 64, d_v to 32 or 128), ragged S beside sagan64's 1024; S just
    # past one 128 tile and two whole ones; rows of 24 and 72 bytes, not
    # multiples of 16, which take the kernels' scalar load path; a single
    # key, and heads one element wide (odd widths, scalar stores); S one
    # short of, at and one short of two 128-key tiles
    SHAPES = [(64, 1024, 8, 32), (2, 100, 8, 32), (3, 100, 16, 32),
              (2, 90, 8, 64), (2, 70, 40, 32), (2, 77, 24, 48),
              (2, 130, 64, 128), (2, 129, 8, 32), (2, 256, 8, 32),
              (2, 100, 12, 36), (3, 1, 8, 32), (2, 50, 1, 1),
              (2, 127, 8, 32), (2, 128, 8, 32), (2, 255, 8, 32)]

    @pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_plain_and_repeats(self, cuda, tdt, shape):
        self._check(cuda, tdt, shape, offset=0)

    @pytest.mark.parametrize("shape", [(2, 100, 8, 32), (64, 1024, 8, 32)])
    def test_misaligned_pointers(self, cuda, shape):
        """q, k, v and do one element into their buffers: 16-byte rows but
        data pointers off 16-byte alignment, the scalar load path of the
        bf16 forward and dkv."""
        self._check(cuda, torch.bfloat16, shape, offset=1)

    def test_negative_scale(self, cuda):
        """softmax(q k^T * scale) with scale < 0: the bf16 forward moves the
        sign into q's fragments and takes the running max with c > 0."""
        self._check(cuda, torch.bfloat16, (2, 129, 8, 32), offset=0,
                    scale=-0.5)

    def _check(self, cuda, tdt, shape, offset, scale=None):
        b, s, dk, dv = shape
        g = torch.Generator(device=cuda).manual_seed(b * s + dk)

        def rand(*sh):
            return torch.randn(sh, generator=g, device=cuda)

        q, k, v = (_at_offset(rand(b, s, d).to(tdt), offset)
                   for d in (dk, dk, dv))
        gout = rand(b, s, dv)
        scale = dk ** -0.5 if scale is None else scale
        before = (flash.flash_fwd.launches, flash.flash_dq.launches,
                  flash.flash_dkv.launches)
        out, lse = flash.flash_fwd(q, k, v, scale)
        want_out, want_lse = flash.flash_fwd_plain(q, k, v, scale)
        do, delta = flash.bwd_stats(q, want_out, gout)
        do = _at_offset(do, offset)
        assert all(bool(t.data_ptr() % 16) == bool(offset)
                   for t in (q, k, v, do))
        dq = flash.flash_dq(q, k, v, do, want_lse, delta, scale)
        dkv = flash.flash_dkv(q, k, v, do, want_lse, delta, scale)
        again = (flash.flash_fwd(q, k, v, scale),
                 flash.flash_dq(q, k, v, do, want_lse, delta, scale),
                 flash.flash_dkv(q, k, v, do, want_lse, delta, scale))
        torch.cuda.synchronize()
        assert (flash.flash_fwd.launches, flash.flash_dq.launches,
                flash.flash_dkv.launches) == tuple(n + 2 for n in before)
        for a, bb in zip((out, lse, dq, *dkv),
                         (*again[0], again[1], *again[2])):
            assert torch.equal(a, bb), "two launches differ"
        # the bounds scale with `scale`: for scale < 0 take them from the
        # same scores written as (-q) . k^T at -scale (-q exact in bf16)
        sign = 1.0 if scale >= 0 else -1.0
        bounds = flash.kernel_error_bounds(q * sign, k, v, do, want_lse,
                                           delta, scale * sign)
        _assert_flash_close("out", out, want_out, bounds["out"], tdt)
        _assert_flash_close("lse", lse, want_lse,
                            1e-5 * (1.0 + want_lse.abs()), tdt)
        want_dq = flash.flash_dq_plain(q, k, v, do, want_lse, delta, scale)
        want_dk, want_dv = flash.flash_dkv_plain(q, k, v, do, want_lse,
                                                 delta, scale)
        _assert_flash_close("dq", dq, want_dq, bounds["dq"], tdt)
        _assert_flash_close("dk", dkv[0], want_dk, bounds["dk"], tdt)
        _assert_flash_close("dv", dkv[1], want_dv, bounds["dv"], tdt)

    def test_autograd_runs_the_kernels(self, cuda):
        """flash_attention's backward on the card is bwd_stats, then one
        dq and one dkv launch, and agrees with the CPU's plain backward
        (f32: 1e-4)."""
        rng = np.random.default_rng(140)
        arrays = [rng.normal(size=(2, 96, d)).astype(np.float32)
                  for d in (8, 8, 32)]
        r = rng.normal(size=(2, 96, 32)).astype(np.float32)
        results = []
        counts = (flash.flash_fwd.launches, flash.flash_dq.launches,
                  flash.flash_dkv.launches)
        for dev in ("cpu", cuda):
            leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                      for a in arrays]
            out = flash.flash_attention(*leaves, 0.3)
            grads = torch.autograd.grad(
                (out * torch.from_numpy(r).to(dev)).sum(), leaves)
            results.append([t.detach().cpu() for t in (out, *grads)])
        assert (flash.flash_fwd.launches, flash.flash_dq.launches,
                flash.flash_dkv.launches) == tuple(n + 1 for n in counts)
        for a, b in zip(*results):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)

    def test_autograd_runs_the_bf16_kernels(self, cuda):
        """In bf16 the backward is bwd_stats, then one launch each of the
        bf16 dq and dkv kernels; dq agrees with its plain version on the
        saved out and lse within kernel_error_bounds."""
        g = torch.Generator(device=cuda).manual_seed(141)
        q, k, v = (torch.randn((2, 129, d), generator=g, device=cuda)
                   .to(torch.bfloat16).requires_grad_(True)
                   for d in (8, 8, 32))
        r = torch.randn((2, 129, 32), generator=g, device=cuda)
        counts = (flash.flash_fwd.launches, flash.flash_dq.launches,
                  flash.flash_dkv.launches)
        out = flash.flash_attention(q, k, v, 0.3)
        dq, = torch.autograd.grad((out * r).sum(), (q,))
        torch.cuda.synchronize()
        assert (flash.flash_fwd.launches, flash.flash_dq.launches,
                flash.flash_dkv.launches) == tuple(n + 1 for n in counts)
        qd, kd, vd = (t.detach() for t in (q, k, v))
        _, lse = flash.flash_fwd(qd, kd, vd, 0.3)
        do, delta = flash.bwd_stats(qd, out.detach(), r)
        bounds = flash.kernel_error_bounds(qd, kd, vd, do, lse, delta, 0.3)
        _assert_flash_close("dq", dq, flash.flash_dq_plain(
            qd, kd, vd, do, lse, delta, 0.3), bounds["dq"], torch.bfloat16)

    def test_rejects_bad_arguments(self, cuda):
        q = torch.zeros((1, 8, 8), device=cuda)
        with pytest.raises(ValueError, match="d_qk"):
            flash.flash_fwd(torch.zeros((1, 8, 65), device=cuda),
                            torch.zeros((1, 8, 65), device=cuda), q, 1.0)
        with pytest.raises(ValueError):
            flash.flash_fwd(q, q.to(torch.bfloat16), q, 1.0)
        with pytest.raises(ValueError, match="contiguous"):
            flash.flash_fwd(q.transpose(1, 2), q, q, 1.0)
