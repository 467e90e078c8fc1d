"""Progressive-resolution training in the port against `dcgan_tpu` on the
CPU (gf = df = 8, 16 px, batch 8).

- the schedule (`parse_schedule` on a table of specs: tests/
  test_torch_progressive_schedule.py): the step arithmetic (`starts`,
  `index_for_dispatch`, `index_for_state`, `alpha_at`) is equal on every
  step of a 3-phase schedule; the TrainConfig refusals carry the JAX
  messages;
- the carry: `carry_path` equal to JAX's on every leaf name of both
  packages' trees for shifts 1 and 2; `carry_state` on trees converted
  with convert.py equal to JAX's merged tree bit for bit;
- the fade equal to JAX's `_make_fade` on a 1-device CPU mesh within 1e-6
  (f32: the same mean and blend, in another order);
- one port step after an "8:2,16:*" switch against the JAX `train_step` on
  the same merged state, within tests/test_torch_train.py's f32
  tolerances (losses 1e-5; leaves 1e-5 abs + 1e-5 rel, the BN-feeding
  biases and running means 2 * lr, Adam's own bound for one step);
- the trainer: a one-phase schedule writes the rows of a run without
  one, wall clock aside; a mid-schedule resume, the boundary checkpoint's
  pre-switch tree, a schedule edited between runs, the consumers'
  model resolution, the warm-up plan and the switch's line; `{res}`
  re-bucketing over `prepare` shards with the quarantine tally carried;
- a JAX run stopped mid-schedule crosses to the port (the sidecar's tag
  into the manifest), which resumes in phase 0 and switches at step 2.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dcgan_tpu import progressive as jprog
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu.config import TrainConfig as JTrainConfig
from dcgan_tpu.elastic.rules import path_str
from dcgan_tpu.train import steps as jsteps
from dcgan_tpu_torch import config, convert, progressive
from dcgan_tpu_torch.config import ModelConfig, TrainConfig
from dcgan_tpu_torch.data import prepare, quarantine
from dcgan_tpu_torch.progressive.phases import PhaseRuntime
from dcgan_tpu_torch.train import steps, trainer
from dcgan_tpu_torch.train.warmup import call_size
from dcgan_tpu_torch.utils.checkpoint import Checkpointer, \
    latest_progressive_tag
from torch_jax_draws import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 8
LR = 2e-4
MODEL = dict(gf_dim=8, df_dim=8, z_dim=8, compute_dtype="float32")
# leaves whose gradient is 0 in exact arithmetic (tests/test_torch_train.py)
PRE_BN = re.compile(r"(proj|deconv[1-9]|conv[1-9])/b$|bn[0-9]+/mean$")


def _model(size=16, **kw):
    return ModelConfig(output_size=size, **dict(MODEL, **kw))


def _jmodel(size=16, **kw):
    return JModelConfig(output_size=size, **dict(MODEL, **kw))


def _cfg(tmp_path, size=16, spec="8:2,16:*", **kw):
    kw.setdefault("model", _model(size))
    kw.setdefault("batch_size", BATCH)
    for k, v in dict(tensorboard=False, sample_every_steps=0,
                     activation_summary_steps=0, nan_check_steps=0,
                     save_summaries_secs=0.0, save_model_secs=1e9,
                     max_steps=100).items():
        kw.setdefault(k, v)
    return TrainConfig(progressive=spec,
                       checkpoint_dir=str(tmp_path / "ckpt"),
                       sample_dir=str(tmp_path / "samples"), **kw)


def _events(directory):
    with open(os.path.join(directory, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _rows(directory):
    """The values of the scalar events."""
    return [e["values"] for e in _events(directory)
            if e["kind"] == "scalars"]


def _tag(directory, step):
    return Checkpointer(directory).progressive_tag_of(step)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

class TestSchedule:
    def test_step_arithmetic_matches_jax(self):
        total = 12
        kw = dict(batch_size=BATCH, max_steps=total, fade_steps=2)
        j = jprog.parse_schedule("8:3,16:4,32:*", model=_jmodel(32), **kw)
        t = progressive.parse_schedule("8:3,16:4,32:*", model=_model(32),
                                       **kw)
        assert t.starts(total) == j.starts(total) == [0, 3, 7]
        for step in range(total + 2):
            assert t.index_for_dispatch(step, total) == \
                j.index_for_dispatch(step, total), step
            assert t.index_for_state(step, total) == \
                j.index_for_state(step, total), step
            assert t.alpha_at(step, total) == j.alpha_at(step, total), step
        # the phases' configs: the model at the phase's size, one shape
        base = TrainConfig(model=_model(32), batch_size=BATCH,
                           progressive="8:3,16:4,32:*", max_steps=total)
        jbase = JTrainConfig(model=_jmodel(32), batch_size=BATCH,
                             progressive="8:3,16:4,32:*", max_steps=total)
        for i in range(3):
            a, b = t.config_for(base, i), j.config_for(jbase, i)
            assert dataclasses.asdict(a.model) == dataclasses.asdict(b.model)
            assert (a.progressive, a.batch_size) == (b.progressive,
                                                     b.batch_size)

    def test_validate_mesh_matches_jax(self):
        msgs = []
        for parse, model in ((jprog.parse_schedule, _jmodel()),
                             (progressive.parse_schedule, _model())):
            s = parse("8:2:6,16:*", model=model, batch_size=BATCH,
                      max_steps=100)
            s.validate_mesh({"data": 1, "model": 1}, spatial=False)
            with pytest.raises(ValueError) as e:
                s.validate_mesh({"data": 4, "model": 1}, spatial=False)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    @pytest.mark.parametrize("kw", [
        {"progressive": "", "progressive_fade_steps": 2},
        {"progressive_fade_steps": -1},
        {"progressive": "8:4,16:4"},
        {"progressive": "8:2,16:*", "fid_every_steps": 4},
        {"progressive": "8:2,16:*", "attn_res": 8}],
        ids=["fade_alone", "fade_negative", "bad_spec", "fid", "attn"])
    def test_config_refusals_match_jax(self, kw):
        """The TrainConfig refusals (and config_from_dict's of a JAX
        config.json's dict) carry the JAX messages."""
        kw = dict(kw)
        attn = kw.pop("attn_res", 0)
        msgs = []
        for cls, model in ((JTrainConfig, _jmodel(attn_res=attn)),
                           (TrainConfig, _model(attn_res=attn))):
            with pytest.raises(ValueError) as e:
                cls(model=model, batch_size=BATCH, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        d = config.config_to_dict(TrainConfig(model=_model(attn_res=attn)))
        with pytest.raises(ValueError) as e:
            config.config_from_dict(dict(d, **kw))
        assert str(e.value) == msgs[0]

    def test_call_never_crosses_a_boundary(self):
        rt = PhaseRuntime(_cfg(pathlib.Path("/nonexistent"),
                               spec="8:4,16:*", steps_per_call=4),
                          progressive.parse_schedule(
                              "8:4,16:*", model=_model(), batch_size=BATCH,
                              max_steps=100, steps_per_call=4), 12)
        assert rt.call_limit() == 4
        # a resume at step 2: single steps up to the boundary
        assert [call_size(s, rt.call_limit(), 4, True)
                for s in (0, 2, 3)] == [4, 1, 1]
        rt.index = 1
        assert rt.call_limit() == 12
        assert call_size(8, rt.call_limit(), 4, True) == 4


# ---------------------------------------------------------------------------
# the carry
# ---------------------------------------------------------------------------

def _jax_template(size):
    """The JAX training state's tree of a `size` px phase, as shapes."""
    jcfg = JTrainConfig(model=_jmodel(size), batch_size=BATCH)
    return jax.eval_shape(jsteps.make_train_step(jcfg).init,
                          jax.random.key(0))


def _states(size, seed, counts=0):
    """(JAX state as numpy, port state) of one fresh tree: the port's
    init of a `size` px phase from `seed`, grafted into the JAX tree by
    the checkpoint tool; with counts > 0 each Adam count set to it and the
    moments seeded non-zero (nu positive), as after that many steps."""
    state = steps.init_train_state(
        TrainConfig(model=_model(size), batch_size=BATCH), seed=seed,
        device="cpu")
    if counts:
        g = torch.Generator().manual_seed(seed)
        for net in ("gen", "disc"):
            opt = state["opt"][net]
            opt["count"].fill_(counts)
            for mu, nu in zip(steps.tree_leaves(opt["mu"]),
                              steps.tree_leaves(opt["nu"])):
                mu.copy_(torch.randn(mu.shape, generator=g) * 1e-3)
                nu.copy_(torch.randn(nu.shape, generator=g) ** 2 * 1e-6)
    jstate = _tool().graft_to_jax(convert.train_state_to_numpy(state),
                                  _jax_template(size))
    return jstate, state


def _jax_paths(state):
    return [path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(state)[0]]


def _jax_carry(old, fresh, shift):
    merged, carried, staged = jprog.carry_state(
        jax.tree_util.tree_map(jnp.asarray, old),
        jax.tree_util.tree_map(jnp.asarray, fresh), arch="dcgan",
        shift=shift)
    assert not staged
    return jax.device_get(merged), carried


class TestCarry:
    @pytest.mark.parametrize("shift", [1, 2])
    def test_carry_path_matches_jax(self, shift):
        port = convert.flatten(steps.init_train_state(
            TrainConfig(model=_model(8), batch_size=BATCH), device="cpu"))
        names = list(port) + _jax_paths(_jax_template(8))
        for name in names:
            for arch in ("dcgan", "resnet"):
                assert progressive.carry_path(
                    name, arch=arch, shift=shift) == jprog.carry_path(
                        name, arch=arch, shift=shift), name
        assert progressive.carry_path("params/gen/deconv1/w", arch="dcgan",
                                      shift=shift) == \
            f"params/gen/deconv{1 + shift}/w"
        assert progressive.carry_path("opt/gen/mu/bn0/scale", arch="dcgan",
                                      shift=shift) is None

    @pytest.mark.parametrize("size,shift", [(16, 1), (32, 2)])
    def test_carry_state_matches_jax(self, size, shift):
        jold, old = _states(8, 0, counts=2)
        jfresh, fresh = _states(size, 1001)
        jmerged, jcarried = _jax_carry(jold, jfresh, shift)
        merged, carried = progressive.carry_state(old, fresh, arch="dcgan",
                                                  shift=shift)
        want = convert.flatten(convert.train_state_from_jax(jmerged,
                                                            device="cpu"))
        got = convert.flatten(merged)
        assert sorted(got) == sorted(want)
        for path in want:
            assert got[path].dtype == want[path].dtype, path
            assert torch.equal(got[path], want[path]), path
        # optax keeps a second count per net (its schedule's), the port one
        assert carried == jcarried - 2
        assert int(merged["opt"]["gen"]["count"]) == 2

    def test_shape_guard(self):
        old = {"params": {"disc": {"head": {"w": torch.ones(4, 1)}}}}
        fresh = {"params": {"disc": {"head": {"w": torch.zeros(8, 1)}}}}
        merged, carried = progressive.carry_state(old, fresh, arch="dcgan",
                                                  shift=1)
        assert carried == 0 and merged["params"]["disc"]["head"]["w"] is \
            fresh["params"]["disc"]["head"]["w"]


# ---------------------------------------------------------------------------
# the fade and the first step after a switch
# ---------------------------------------------------------------------------

class TestFade:
    def test_fade_matches_jax(self):
        from dcgan_tpu.parallel import make_mesh
        from dcgan_tpu.progressive.phases import _make_fade

        jcfg = JTrainConfig(model=_jmodel(), batch_size=BATCH,
                            progressive="8:2,16:*",
                            progressive_fade_steps=2)
        jfade = _make_fade(jcfg, make_mesh(jcfg.mesh, jax.devices()[:1]))
        x = np.random.default_rng(3).uniform(
            -1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
        for alpha in (0.0, 0.25, 0.5, 1.0):
            want = np.asarray(jfade(jnp.asarray(x), np.float32(alpha)))
            got = progressive.fade(torch.from_numpy(x), alpha).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_fade_window(self, tmp_path):
        cfg = _cfg(tmp_path, progressive_fade_steps=2)
        rt = PhaseRuntime(cfg, progressive.parse_schedule(
            cfg.progressive, model=cfg.model, batch_size=BATCH,
            max_steps=cfg.max_steps, fade_steps=2), 6)
        x = torch.rand(2, 16, 16, 3)
        assert rt.fade_images(x, 0) is x          # phase 0 never fades
        rt.index = 1
        assert rt.alpha(2) == 0.5 and rt.fade_images(x, 3) is x
        assert not torch.equal(rt.fade_images(x, 2), x)
        assert rt.scalar_extras(3) == {"progressive/phase": 1.0,
                                       "progressive/resolution": 16.0,
                                       "progressive/alpha": 0.5}


class TestPostSwitchStep:
    def test_first_step_after_switch_matches_jax(self):
        """An "8:2,16:*" switch from a phase-0 state with Adam moments
        and counts as after two steps, carried by each package onto the
        same fresh 16 px tree; then one step of each on the same images
        and z."""
        from torch_jax_draws import step_draws

        jold, old = _states(8, 0, counts=2)
        jfresh, fresh = _states(16, 1001)
        jmerged, _ = _jax_carry(jold, jfresh, 1)
        merged, _ = progressive.carry_state(old, fresh, arch="dcgan",
                                            shift=1)
        jcfg = JTrainConfig(model=_jmodel(), batch_size=BATCH)
        tcfg = TrainConfig(model=_model(), batch_size=BATCH)
        images = np.tanh(np.random.default_rng(1).normal(
            size=(BATCH, 16, 16, 3))).astype(np.float32)
        key = jax.random.key(9)
        z, _ = step_draws(jcfg, key, BATCH)
        jnew, jm = jax.jit(jsteps.make_train_step(jcfg).train_step)(
            jax.tree_util.tree_map(jnp.asarray, jmerged),
            jnp.asarray(images), key)
        tnew, tm = steps.make_train_step(tcfg).train_step(
            merged, torch.from_numpy(images), torch.from_numpy(np.array(z)))
        for k in trainer.METRIC_KEYS:
            assert abs(float(jm[k]) - float(tm[k])) <= 1e-5, k
        want = convert.flatten(convert.train_state_from_jax(
            jax.device_get(jnew), device="cpu"))
        got = convert.flatten(tnew)
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            bound = 2 * LR if PRE_BN.search(path) else 1e-5 + 1e-5 * float(
                w.double().abs().max())
            err = float((got[path].double() - w.double()).abs().max())
            assert err <= bound, (path, err, bound)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _train(cfg, steps_, **kw):
    return trainer.train(cfg, synthetic_data=True, max_steps=steps_,
                         device="cpu", **kw)


class TestTrainer:
    def test_single_phase_schedule_writes_the_same_rows(self, tmp_path):
        def rows(sub, spec):
            cfg = dataclasses.replace(
                _cfg(tmp_path / sub, spec=spec), nan_check_steps=2)
            _train(cfg, 4)
            out = []
            for e in _events(cfg.checkpoint_dir):
                e.pop("time")
                e["values"] = {k: v for k, v in e["values"].items()
                               if not k.startswith("perf/")}
                out.append(json.dumps(e, sort_keys=True))
            return out

        assert rows("plain", "") == rows("prog", "16:*")

    def test_resume_mid_schedule(self, tmp_path, capsys):
        cfg = _cfg(tmp_path, size=32, spec="8:2,16:2,32:*")
        _train(cfg, 3)                      # stops inside r16
        assert _tag(cfg.checkpoint_dir, 3) == {"phase": 1, "resolution": 16}
        # the consumers build the 16 px model; an explicit flag wins
        assert config.resolve_model_config(
            cfg.checkpoint_dir).output_size == 16
        assert config.resolve_model_config(
            cfg.checkpoint_dir, overrides={"output_size": 32}
        ).output_size == 32
        state = _train(cfg, 6)
        out = capsys.readouterr().out
        assert "starting in phase 1 (r16" in out
        assert "progressive phase 2 at step 4: r16 -> r32" in out
        assert int(state["step"]) == 6
        assert _tag(cfg.checkpoint_dir, 6) == {"phase": 2, "resolution": 32}
        rows = _rows(cfg.checkpoint_dir)
        assert [r["progressive/resolution"] for r in rows
                if "d_loss" in r] == [8, 8, 16, 16, 32, 32]
        assert sum("progressive/switch_ms" in r for r in rows) == 2

    def test_boundary_checkpoint_holds_the_old_tree(self, tmp_path, capsys):
        cfg = _cfg(tmp_path)
        _train(cfg, 2)
        assert _tag(cfg.checkpoint_dir, 2) == {"phase": 0, "resolution": 8}
        template = steps.init_train_state(
            dataclasses.replace(cfg, progressive="", model=_model(8)),
            device="cpu")
        assert Checkpointer(cfg.checkpoint_dir).restore_latest(template)
        state = _train(cfg, 4)
        out = capsys.readouterr().out
        assert "starting in phase 0 (r8" in out
        assert "progressive phase 1 at step 2: r8 -> r16" in out
        assert int(state["step"]) == 4

    def test_edited_schedule_refused(self, tmp_path):
        cfg = _cfg(tmp_path)
        _train(cfg, 3)                      # saved in phase 1
        moved = dataclasses.replace(cfg, progressive="8:4,16:*")
        with pytest.raises(ValueError, match="spec changed"):
            _train(moved, 6)

    def test_aot_plan_and_switch_line(self, tmp_path, capsys):
        """--aot_warmup captures every phase's rows at startup (`@r16`
        for the later phase), the switch captures nothing, and the
        carried count is carry_state's for the two trees."""
        cfg = _cfg(tmp_path, aot_warmup=True, sample_every_steps=2,
                   progressive_fade_steps=2)
        _train(cfg, 4)
        out = capsys.readouterr().out
        compile_ms = [r for r in _rows(cfg.checkpoint_dir)
                      if any(k.startswith("perf/compile_ms/") for k in r)]
        assert sorted(compile_ms[0]) == [
            "perf/compile_ms/sampler", "perf/compile_ms/sampler@r16",
            "perf/compile_ms/train_step", "perf/compile_ms/train_step@r16"]
        _, carried = progressive.carry_state(
            steps.init_train_state(dataclasses.replace(
                cfg, progressive="", progressive_fade_steps=0,
                model=_model(8)), device="cpu"),
            steps.init_train_state(dataclasses.replace(
                cfg, progressive="", progressive_fade_steps=0),
                device="cpu"), arch="dcgan", shift=1)
        line = [ln for ln in out.splitlines() if "r8 -> r16" in ln]
        assert len(line) == 1 and f"{carried} leaves carried" in line[0]
        assert line[0].endswith("captures_during_switch=0")
        alphas = [r["progressive/alpha"] for r in _rows(cfg.checkpoint_dir)
                  if "progressive/alpha" in r]
        assert alphas and all(0 < a < 1 for a in alphas)
        grids = sorted(os.listdir(cfg.sample_dir))
        assert grids == ["train_00000002.png", "train_00000004.png"]
        # the grid of each phase at its resolution (rows x 8, cols x 16)
        assert [Image.open(os.path.join(cfg.sample_dir, g)).size
                for g in grids] == [(64, 64), (128, 128)]


# ---------------------------------------------------------------------------
# re-bucketing
# ---------------------------------------------------------------------------

def _flip_payload(path, record):
    """Flip one pixel byte of record `record` of a shard of equal-size
    records."""
    raw = bytearray(open(path, "rb").read())
    length = int.from_bytes(raw[:8], "little")
    raw[record * (16 + length) + 12 + 100] ^= 0x40
    open(path, "wb").write(bytes(raw))


class TestRebucket:
    def test_phase_data_cfg_matches_jax(self, tmp_path):
        kw = dict(data_dir="train_{res}", sample_image_dir="held_{res}")
        cfg = _cfg(tmp_path, **kw)
        jcfg = JTrainConfig(model=_jmodel(), batch_size=BATCH,
                            progressive="8:2,16:*", **kw)
        for i in range(2):
            p = progressive.phase_data_cfg(progressive.parse_schedule(
                cfg.progressive, model=cfg.model, batch_size=BATCH,
                max_steps=cfg.max_steps).config_for(cfg, i))
            j = jprog.phase_data_cfg(jprog.parse_schedule(
                jcfg.progressive, model=jcfg.model, batch_size=BATCH,
                max_steps=jcfg.max_steps).config_for(jcfg, i))
            assert (p.data_dir, p.sample_image_dir) == \
                (j.data_dir, j.sample_image_dir) == \
                (f"train_{8 * 2 ** i}", f"held_{8 * 2 ** i}")
        plain = _cfg(tmp_path, spec="")
        assert progressive.phase_data_cfg(plain) is plain

    def test_reopen_closes_then_opens_and_carries_the_tally(self):
        opened = []

        class Feed:
            closed = False

            def close(self):
                self.closed = True

        def open_fn(phase_cfg, skip):
            opened.append((Feed(), skip))
            return opened[-1][0], None

        rb = progressive.Rebucketer(open_fn)
        rb.open(_cfg(pathlib.Path("/x")), 3)
        base = quarantine.count()
        quarantine.add(1)
        rb.reopen(_cfg(pathlib.Path("/x")))
        assert opened[0][0].closed and not opened[1][0].closed
        assert [skip for _, skip in opened] == [3, 0]
        assert rb.last_tally == base + 1 and rb.reopens == 1
        rb.close()
        assert opened[1][0].closed

    def test_res_shards_rebucket_with_quarantine(self, tmp_path):
        """`prepare` shards under train_{res} for each phase, one record
        corrupted in each: the switch re-opens the native loader at 16 px
        and the run's corrupt-record count goes on from phase 0's."""
        rng = np.random.default_rng(0)
        src = tmp_path / "photos"
        src.mkdir()
        for i in range(24):
            Image.fromarray(rng.integers(0, 256, (20, 20, 3),
                                         dtype=np.uint8)).save(
                src / f"img{i}.png")
        for res in (8, 16):
            out = tmp_path / f"train_{res}"
            prepare.main(["--input_dir", str(src), "--output_dir", str(out),
                          "--image_size", str(res), "--crop_size", "0",
                          "--num_shards", "1"])
            _flip_payload(str(out / "shard-00000.tfrecord"), 1)
        cfg = _cfg(tmp_path, data_dir=str(tmp_path / "train_{res}"),
                   max_corrupt_records=10, shuffle_buffer=8,
                   num_loader_threads=1)
        state = trainer.train(cfg, max_steps=6, device="cpu")
        assert int(state["step"]) == 6
        counts = [r.get("data/corrupt_records", 0)
                  for r in _rows(cfg.checkpoint_dir) if "d_loss" in r]
        assert counts[1] == 1 and counts[-1] == 2, counts


# ---------------------------------------------------------------------------
# a JAX run stopped mid-schedule, resumed in the port
# ---------------------------------------------------------------------------

def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint",
        ROOT / "tools" / "export_torch_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_mid_schedule_checkpoint_resumes_in_the_port(tmp_path, capsys):
    from dcgan_tpu.train.trainer import train as jtrain

    jcfg = JTrainConfig(
        model=_jmodel(), batch_size=BATCH, progressive="8:2,16:*",
        max_steps=100, tensorboard=False, sample_every_steps=0,
        activation_summary_steps=0, nan_check_steps=0,
        save_summaries_secs=0.0, save_model_secs=1e9,
        checkpoint_dir=str(tmp_path / "jax"),
        sample_dir=str(tmp_path / "jax_samples"))
    jtrain(jcfg, synthetic_data=True, max_steps=2)
    tool = _tool()
    port_dir = str(tmp_path / "port")
    assert tool.export(jcfg.checkpoint_dir, port_dir) == 2
    assert _tag(port_dir, 2) == {"phase": 0, "resolution": 8}
    cfg = dataclasses.replace(config.load_config(port_dir),
                              checkpoint_dir=port_dir,
                              sample_dir=str(tmp_path / "samples"))
    capsys.readouterr()
    state = trainer.train(cfg, synthetic_data=True, max_steps=4,
                          device="cpu")
    out = capsys.readouterr().out
    assert "starting in phase 0 (r8" in out
    assert "progressive phase 1 at step 2: r8 -> r16" in out
    assert int(state["step"]) == 4
    # and back: the port's newest step is phase 1's 16 px tree
    assert latest_progressive_tag(port_dir) == {"phase": 1,
                                                "resolution": 16}
    template = jax.device_get(jax.jit(jsteps.make_train_step(
        JTrainConfig(model=_jmodel(), batch_size=BATCH)).init)(
            jax.random.key(0)))
    jstate = tool.port_to_jax_state(port_dir, template)
    assert int(jstate["step"]) == 4
