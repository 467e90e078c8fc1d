"""The conditional serving artifact on the CPU (K = 4, 16 px, gf = df =
8, z 8): a conditional checkpoint exports as call(z, labels) with the JAX
exporter's calling convention and images (f32 1e-4, the sampler's
tolerance against the JAX package), and a conditional-BN artifact serves
labelled requests through ArtifactSource within 1e-4 of the plain
sampler. (tests/test_torch_export.py's helpers; a file of its own to keep
each file's time on the CPU short.)
"""

import dataclasses

import numpy as np
import torch

from dcgan_tpu_torch import export as t_export
from dcgan_tpu_torch.models.dcgan import sampler_apply
from dcgan_tpu_torch.serve.server import SamplerServer
from dcgan_tpu_torch.serve.sources import ArtifactSource
from test_torch_export import SERVED_TOL, TIMEOUT, _checkpoint, _export, \
    _jax_export, _z


class TestConditionalArtifact:
    def test_equals_the_jax_exporter(self, tmp_path, monkeypatch):
        """A conditional checkpoint (K = 4) exports as call(z, labels),
        with num_classes in the sidecar: the JAX exporter's calling
        convention, and its program's images within f32 1e-4 for every
        class and for labels out of range (JAX's zero one-hot). (The JAX
        exporter fails on a conditional-BN checkpoint: its sampler
        gathers from the restored tables as numpy arrays.)"""
        root, cfg, state = _checkpoint(str(tmp_path / "ckpt"),
                                       compute_dtype="float32",
                                       num_classes=4)
        t_meta = _export(root, tmp_path / "t.pt2")
        j_meta, j_program = _jax_export(monkeypatch, root,
                                        tmp_path / "j.jaxexport")
        for key in ("call", "z_dim", "num_classes", "image_shape", "batch",
                    "serving"):
            assert t_meta[key] == j_meta[key], key
        assert t_meta["num_classes"] == 4 and "labels" in t_meta["call"]
        program = t_export.load_sampler(str(tmp_path / "t.pt2"))
        z = _z(8, seed=2)
        for labels in (np.arange(8) % 4, np.array([-1, 4, 7, -5] * 2)):
            labels = labels.astype(np.int32)
            got = program(torch.from_numpy(z),
                          torch.from_numpy(labels)).numpy()
            want = np.asarray(j_program.call(z, labels), np.float32)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert want.std() > 0.3

    def test_cbn_artifact_serves_labels(self, tmp_path):
        """A conditional-BN artifact through `serve --artifact`'s source:
        each request's rows with its labels (none: class 0) equal the
        plain sampler on them within SERVED_TOL."""
        root, cfg, state = _checkpoint(str(tmp_path / "ckpt"),
                                       compute_dtype="float32",
                                       num_classes=4, conditional_bn=True,
                                       use_pallas=True)
        out = str(tmp_path / "c.pt2")
        meta = _export(root, out)
        assert meta["num_classes"] == 4
        src = ArtifactSource(out, device="cpu")
        assert src.num_classes == 4
        server = SamplerServer(src, max_batch=8, max_wait_ms=1.0)
        server.start(timeout=TIMEOUT)
        reqs = [(_z(3, 5), np.array([3, 0, 1], np.int32)), (_z(2, 6), None)]
        got = [server.submit(z=z, labels=lab) for z, lab in reqs]
        server.stop(timeout=TIMEOUT)
        mcfg = dataclasses.replace(cfg.model, use_pallas=False)
        for (z, lab), r in zip(reqs, got):
            lab = np.zeros(len(z), np.int32) if lab is None else lab
            want = sampler_apply(state["params"]["gen"], state["bn"]["gen"],
                                 torch.from_numpy(z), cfg=mcfg,
                                 labels=torch.from_numpy(lab)).numpy()
            assert want.std() > 0.3
            np.testing.assert_allclose(r.result(0), want, rtol=0,
                                       atol=SERVED_TOL)
