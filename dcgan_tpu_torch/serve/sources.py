"""Weight sources for the sampler server (the counterpart of
`dcgan_tpu/serve/sources.py`):

- `CheckpointSource` serves the generator of a training checkpoint
  directory: the newest intact step, restored through the Checkpointer's
  verified restore (a corrupt newest step is marked `.corrupt` and the one
  before it is served), the live or the EMA weights, optionally int8
  quantize-dequantized (serve/quantize.py). Its `reload()` is the weight
  promotion: the newest finalized step copied into the tensors the rungs
  were captured over;
- `WeightsSource` serves an `.npz` written by `convert.save_weights`;
- `StateSource` serves a generator already in memory (generate.py's
  restored checkpoint);
- `ArtifactSource` serves a `.pt2` written by `python -m
  dcgan_tpu_torch.export` (a `torch.export` program with the weights in
  it) through its JSON sidecar; it imports nothing of the models.

All present the surface the worker thread drives:

- `prepare()`: load the weights onto the device (cold start, on the
  dispatch thread); returns the source's metadata;
- `bucket_plan(ladder)` / `bind(rungs)` / `compiled_buckets()`: the rungs
  this source will serve. `bind` gives each rung a static z input (and,
  for a conditional model, `num_classes` > 0, a static int32 labels
  input beside it) and runs the sampler on it once eagerly (the warm-up:
  it builds the kernels and lets cuDNN pick its algorithms), then
  captures it as a CUDA graph with its static output (graphs.py; eager on
  the CPU), timing each capture into `compile_ms` under the JAX row name
  `sampler@b<rung>`;
- `sample(bucket, z[, labels])`: z and the labels copied into the rung's
  inputs (a conditional rung given no labels copies zeros, class 0, as
  the JAX sources do; an unconditional one ignores them), one replay, the
  image copied out to a host float32 array [bucket, S, S, c_dim]
  (`run(bucket, z[, labels])` is the same replay, its image left on the
  device: the eval job's sampler). A captured rung reads the addresses
  it was captured with, so its inputs are written in place, never
  rebound. `captures` counts every capture, so the server
  can report the captures after warm-up (`serve/recompiles_after_warmup`,
  0 by construction: an unbound rung raises instead of being captured);
- `close()`: release every rung's graph and its private pool now (the
  dispatch thread calls it when it ends), instead of when the garbage
  collector breaks the cycle between a program and its source.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dcgan_tpu_torch.device import resolve_device
from dcgan_tpu_torch.graphs import CapturedProgram, on_stream
from dcgan_tpu_torch.serve.buckets import BucketLadder


def latest_finalized_step(checkpoint_dir: str) -> Optional[int]:
    """The newest finalized checkpoint step under `checkpoint_dir`, or None.
    A step directory is written under a temporary name and renamed when
    complete, so an integer-named one is finalized. An IO error reads as
    "nothing new": the promotion watcher polls this and must not crash on
    a filesystem blip."""
    try:
        steps = [int(d) for d in os.listdir(checkpoint_dir) if d.isdigit()]
    except OSError:
        return None
    return max(steps) if steps else None


class _RungSource:
    """Captured rungs over a sampler function of z: `bind` warms up and
    captures one program per rung, `sample` replays one, `close` releases
    them all. A subclass's `prepare()` sets z_dim and `_sampler`."""

    def __init__(self, device: Union[str, torch.device]):
        self.device = resolve_device(device)
        self.z_dim = 0          # known after prepare()
        self.num_classes = 0    # > 0: conditional, known after prepare()
        self.granule = 1        # one device: any batch size tiles
        self._rungs: Dict[int, Tuple[torch.Tensor, Optional[torch.Tensor],
                                     CapturedProgram]] = {}
        self.compile_ms: Dict[str, float] = {}
        self.captures = 0

    def prepare(self) -> dict:
        raise NotImplementedError

    def _sampler(self, z: torch.Tensor,
                 labels: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def bucket_plan(self, ladder: BucketLadder) -> Tuple[int, ...]:
        return tuple(ladder.buckets)

    def bind(self, rungs: Sequence[int]) -> None:
        """Warm up and capture one sampler program per rung."""
        stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        for b in sorted(rungs):
            if b in self._rungs:
                continue
            z = torch.zeros((b, self.z_dim), dtype=torch.float32,
                            device=self.device)
            labels = torch.zeros((b,), dtype=torch.int32,
                                 device=self.device) \
                if self.num_classes else None

            def fn(z=z, labels=labels):
                return self._sampler(z, labels)
            with on_stream(stream):
                fn()
            prog = CapturedProgram(f"sampler@b{b}", fn, self.device, stream)
            self.compile_ms[prog.name] = prog.capture()
            self.captures += 1
            self._rungs[b] = (z, labels, prog)

    def compiled_buckets(self) -> Tuple[int, ...]:
        """Ascending bound bucket rungs."""
        return tuple(sorted(self._rungs))

    def run(self, bucket: int, z, labels=None) -> torch.Tensor:
        """One replay of rung `bucket` on z (and labels): arrays or tensors
        on any device, copied into the rung's inputs. Returns the rung's
        output on the source's device, which the rung's next run
        overwrites (the eval job reads it on the device)."""
        if bucket not in self._rungs:
            raise KeyError(f"bucket {bucket} is not a bound rung "
                           f"{self.compiled_buckets()}")
        z = torch.as_tensor(z, dtype=torch.float32)
        if tuple(z.shape) != (bucket, self.z_dim):
            raise ValueError(f"z must be [{bucket}, {self.z_dim}], got "
                             f"{tuple(z.shape)}")
        z_in, labels_in, prog = self._rungs[bucket]
        z_in.copy_(z)
        if labels_in is not None:
            if labels is None:
                labels_in.zero_()
            else:
                labels = torch.as_tensor(labels, dtype=torch.int32)
                if tuple(labels.shape) != (bucket,):
                    raise ValueError(f"labels must be [{bucket}], got "
                                     f"{tuple(labels.shape)}")
                labels_in.copy_(labels)
        return prog.run()

    def sample(self, bucket: int, z: np.ndarray,
               labels: Optional[np.ndarray] = None) -> np.ndarray:
        if labels is not None:
            labels = np.asarray(labels, np.int32)
        return self.run(bucket, np.asarray(z, np.float32),
                        labels).cpu().numpy()

    def close(self) -> None:
        """Release every rung's program (its graph and private pool); the
        source serves no more until it binds again."""
        rungs, self._rungs = self._rungs, {}
        for _, _, prog in rungs.values():
            prog.release()


class _GeneratorSource(_RungSource):
    """The serving surface over a generator's (params, BN state) and its
    ModelConfig, which a subclass's `prepare()` loads."""

    def __init__(self, device: Union[str, torch.device]):
        super().__init__(device)
        self.cfg = None
        self._params = None
        self._state = None

    def _sampler(self, z: torch.Tensor,
                 labels: Optional[torch.Tensor]) -> torch.Tensor:
        from dcgan_tpu_torch.models.dcgan import sampler_apply

        return sampler_apply(self._params, self._state, z, cfg=self.cfg,
                             labels=labels)


class CheckpointSource(_GeneratorSource):
    """Serve the generator of the newest intact checkpoint in a training
    checkpoint directory. The architecture: explicit `overrides` >
    `preset` > the directory's config.json > ModelConfig defaults
    (`config.resolve_model_config`); the state's other fields (its
    precision policy) from config.json when there is one. `quantize="int8"`
    serves both weight copies, live and EMA, quantize-dequantized.
    `max_batch` is the JAX signature's (its mesh granule); one device
    tiles any batch."""

    def __init__(self, checkpoint_dir: str, *, use_ema: bool = False,
                 preset: Optional[str] = None,
                 overrides: Optional[dict] = None,
                 max_batch: int = 64, quantize: str = "",
                 device: Union[str, torch.device] = "cuda"):
        if quantize not in ("", "int8"):
            raise ValueError(
                f"quantize must be '' or 'int8', got {quantize!r}")
        super().__init__(device)
        self.checkpoint_dir = checkpoint_dir
        self.use_ema = use_ema
        self.preset = preset
        self.overrides = overrides
        self.max_batch = max_batch
        self.quantize = quantize
        self._ckpt = None
        self._template = None

    def prepare(self) -> dict:
        from dcgan_tpu_torch.config import consumer_train_config, \
            resolve_model_config
        from dcgan_tpu_torch.train.steps import init_train_state, tree_map
        from dcgan_tpu_torch.utils.checkpoint import Checkpointer

        mcfg = resolve_model_config(self.checkpoint_dir, preset=self.preset,
                                    overrides=self.overrides)
        cfg = consumer_train_config(self.checkpoint_dir, mcfg)
        # the restore's template lives on the host, as empty tensors: only
        # its tree, shapes and dtypes matter, and only G goes to the device
        self._template = tree_map(
            lambda v: torch.empty(v.shape, dtype=v.dtype),
            init_train_state(cfg, device="cpu"))
        self._ckpt = Checkpointer(self.checkpoint_dir)
        step, params, state, report = self._restore()
        self.cfg = mcfg
        self._params = tree_map(lambda t: t.to(self.device), params)
        self._state = tree_map(lambda t: t.to(self.device), state)
        self.z_dim = mcfg.z_dim
        self.num_classes = mcfg.num_classes
        return self._meta(step, report)

    def _restore(self):
        """(step, G params, G BN state, int8 report or None) of the newest
        intact step, on the host. Transient IO errors retry with backoff; a
        checkpoint that stays broken raises."""
        from dcgan_tpu_torch.utils.retry import retry_io

        restored = retry_io(lambda: self._ckpt.restore_latest(
            self._template), tag="serve-restore")
        if restored is None:
            raise FileNotFoundError(
                f"no checkpoint under {self.checkpoint_dir}")
        restored, report = self._maybe_quantize(restored)
        params = restored["ema_gen"] if self.use_ema \
            else restored["params"]["gen"]
        return int(restored["step"]), params, restored["bn"]["gen"], report

    def _maybe_quantize(self, restored):
        """The int8 serving rung, when armed: both weight copies go through
        int8, so the live and the EMA generator cannot differ in fidelity.
        Returns (state, report or None)."""
        if self.quantize != "int8":
            return restored, None
        from dcgan_tpu_torch.serve.quantize import quantize_dequantize_int8

        gen_q, report = quantize_dequantize_int8(restored["params"]["gen"])
        ema_q, _ = quantize_dequantize_int8(restored["ema_gen"])
        restored = dict(restored)
        restored["params"] = dict(restored["params"], gen=gen_q)
        restored["ema_gen"] = ema_q
        return restored, report

    def _meta(self, step: int, report: Optional[dict]) -> dict:
        meta = {"source": "checkpoint", "step": step,
                "weights": "ema" if self.use_ema else "live",
                "device": str(self.device)}
        if report is not None:
            meta["quantize"] = report
        return meta

    def stage_reload(self):
        """The host half of a promotion, which touches no device and may
        run on any thread once the source is prepared: restore the newest
        finalized step and check its tree, shapes and dtypes against the
        served leaves. Raises when the newest step fails verification (the
        restore fell back to an older step) or anything differs. Returns
        the staged promotion that `reload` copies."""
        from dcgan_tpu_torch.convert import flatten

        newest = latest_finalized_step(self.checkpoint_dir)
        step, params, state, report = self._restore()
        if newest is not None and step < newest:
            raise ValueError(
                f"checkpoint step {newest} in {self.checkpoint_dir} failed "
                f"verification; step {step} restored instead, the served "
                "weights are kept")
        pairs = []
        for name, new, live in (("params", params, self._params),
                                ("state", state, self._state)):
            new, live = flatten(new), flatten(live)
            if sorted(new) != sorted(live):
                raise ValueError(
                    f"step {step}'s generator {name} tree differs from the "
                    f"served one: {sorted(set(new) ^ set(live))[:8]}")
            for path, t in new.items():
                if t.shape != live[path].shape \
                        or t.dtype != live[path].dtype:
                    raise ValueError(
                        f"step {step}: {name}/{path} is {tuple(t.shape)} "
                        f"{t.dtype}, the served leaf "
                        f"{tuple(live[path].shape)} {live[path].dtype}")
                pairs.append((live[path], t))
        return step, pairs, report

    def reload(self, staged=None) -> dict:
        """Promote the newest finalized step (or the promotion `staged`
        by `stage_reload`): copy each leaf (the conditional-BN tables too:
        they are G's params) into the tensor the rungs were captured over
        (a captured graph reads the addresses it was captured with; kernel
        5's TMA descriptors are encoded from them), on the calling
        thread's stream, which the next replay runs on. When it stages
        here, it raises as `stage_reload` does before it copies anything:
        the old weights keep serving. Returns the metadata."""
        step, pairs, report = self.stage_reload() if staged is None \
            else staged
        with torch.no_grad():
            for live, t in pairs:
                live.copy_(t)
        return self._meta(step, report)

    def latest_step_on_disk(self) -> Optional[int]:
        """The promotion watcher's probe: the newest finalized step."""
        return latest_finalized_step(self.checkpoint_dir)


class WeightsSource(_GeneratorSource):
    """Serve the generator stored in a `save_weights` npz."""

    def __init__(self, path: str, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.path = path

    def prepare(self) -> dict:
        from dcgan_tpu_torch.convert import load_weights

        self.cfg, self._params, self._state = load_weights(
            self.path, device=self.device)
        self.z_dim = self.cfg.z_dim
        self.num_classes = self.cfg.num_classes
        return {"source": "weights", "step": None, "weights": self.path,
                "device": str(self.device)}


class StateSource(_GeneratorSource):
    """Serve a generator already in memory: (ModelConfig, params, BN
    state) on the source's device."""

    def __init__(self, cfg, params, state, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.cfg = cfg
        self._params = params
        self._state = state
        self.z_dim = cfg.z_dim
        self.num_classes = cfg.num_classes

    def prepare(self) -> dict:
        return {"source": "state", "step": None, "weights": "memory",
                "device": str(self.device)}


class ArtifactSource(_RungSource):
    """Serve an `export.py` artifact: a `torch.export` program (`.pt2`)
    with the generator's weights in it, and its JSON sidecar, which gives
    the calling convention (z_dim, num_classes, the ladder hint): a
    conditional artifact is called as (z, labels). No checkpoint and
    nothing of the models: the program runs on the device in its sidecar.
    Each rung gets a static z, an eager warm-up and a capture, as the
    other sources' rungs do. There is no `reload()`: the weights are in
    the program, and a promotion ticket fails without harm to the
    replica."""

    def __init__(self, path: str, *,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(device)
        self.path = path
        sidecar_path = path + ".json"
        if not os.path.exists(sidecar_path):
            raise FileNotFoundError(
                f"artifact sidecar {sidecar_path} not found — export.py "
                "writes it next to the artifact; the server needs its "
                "calling convention (z_dim / num_classes / ladder hint)")
        with open(sidecar_path) as f:
            self.sidecar = json.load(f)
        if self.device.type not in self.sidecar.get("platforms", ()):
            raise ValueError(
                f"artifact {path} was exported for "
                f"{self.sidecar.get('platforms')}, not {self.device.type}")
        self.z_dim = int(self.sidecar["z_dim"])
        self.num_classes = int(self.sidecar.get("num_classes", 0) or 0)
        self._program: Optional[Callable] = None

    def ladder_hint(self) -> Optional[list]:
        """The exporter's suggested bucket ladder (the sidecar's serving
        block)."""
        return (self.sidecar.get("serving") or {}).get("bucket_ladder")

    def prepare(self) -> dict:
        self._program = torch.export.load(self.path).module()
        serving = self.sidecar.get("serving") or {}
        return {"source": "artifact", "step": self.sidecar.get("step"),
                "weights": serving.get("source",
                                       self.sidecar.get("weights", "live")),
                "device": str(self.device)}

    def _sampler(self, z: torch.Tensor,
                 labels: Optional[torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            if labels is None:
                return self._program(z)
            return self._program(z, labels)
