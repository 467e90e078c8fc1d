"""Class conditioning on the card: the captured rungs' labels slot and the
captured conditional-BN step. Every test here needs a CUDA device and
skips without one; the module imports nothing of JAX, so the card's
machine runs it with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_conditional_cuda.py

The same paths run eagerly on the CPU in tests/test_torch_serve.py and
tests/test_torch_conditional_train.py.
"""

import numpy as np
import pytest
import torch

from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.convert import flatten
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.train.steps import make_train_step
from dcgan_tpu_torch.train.warmup import StepRunner, metric_keys

K = 4
MODEL = dict(output_size=32, gf_dim=16, df_dim=16, z_dim=16,
             compute_dtype="bfloat16", num_classes=K)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only on the card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("route", [
    {"use_pallas": True, "pallas_fused": True},
    {"use_pallas": True, "conditional_bn": True}])
def test_captured_rung_reads_its_labels_slot(cuda, route):
    """One z under two label sets through one captured rung: two images,
    each the eager sampler's on those labels bit for bit (a rung that
    rebound its labels would serve the capture's); no labels is class
    0."""
    from dcgan_tpu_torch.models.dcgan import generator_init
    from dcgan_tpu_torch.serve.sources import StateSource

    cfg = ModelConfig(**MODEL, **route)
    params, state = generator_init(cfg, seed=3, device=cuda)
    src = StateSource(cfg, params, state, device=cuda)
    src.bind((8,))
    z = np.random.default_rng(0).uniform(-1, 1, (8, 16)).astype(np.float32)
    outs = {}
    for name, lab in (("a", np.arange(8) % K), ("b", (np.arange(8) + 1) % K),
                      ("none", np.zeros(8))):
        lab = lab.astype(np.int32)
        outs[name] = src.sample(8, z, None if name == "none" else lab)
        want = sampler_apply(params, state, torch.from_numpy(z).to(cuda),
                             cfg=cfg, labels=torch.from_numpy(lab).to(cuda))
        np.testing.assert_array_equal(outs[name],
                                      want.float().cpu().numpy())
    src.close()
    assert not np.array_equal(outs["a"], outs["b"])
    assert src.captures == 1


@pytest.mark.cuda
def test_captured_conditional_bn_step_equals_eager(cuda):
    """Three conditional-BN steps (kernel 1's moments, the per-class
    epilogue) eager and through the runner at K = 1: every metric and
    state leaf bit for bit; the table gradient is a reduction, not an
    atomic scatter."""
    cfg = TrainConfig(model=ModelConfig(**MODEL, use_pallas=True,
                                        conditional_bn=True), batch_size=8)
    fns = make_train_step(cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    images = [torch.rand((8, 32, 32, 3), generator=g, device=cuda) * 2 - 1
              for _ in range(3)]
    zs = [torch.rand((8, 16), generator=g, device=cuda) * 2 - 1
          for _ in range(3)]
    labels = [((torch.arange(8, device=cuda) + i) % K).int()
              for i in range(3)]
    state = fns.init(seed=0, device=cuda)
    eager = []
    for i in range(3):
        state, m = fns.train_step(state, images[i], zs[i], {}, labels[i])
        eager.append([float(m[k]) for k in metric_keys(cfg)])
    runner = StepRunner(fns, fns.init(seed=0, device=cuda), cfg, cuda)
    got = []
    for i in range(3):
        got += runner.step(images[i:i + 1], zs[i:i + 1], [{}], start=i,
                           labels=labels[i:i + 1]).tolist()
    assert got == eager
    for path, t in flatten(state).items():
        assert torch.equal(flatten(runner.state)[path], t), path
    assert "train_step" in runner.programs
    runner.close()
