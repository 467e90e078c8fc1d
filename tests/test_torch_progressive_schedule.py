"""`parse_schedule` of the port against `dcgan_tpu`'s on a table of
specs: equal phases and fade, or the same ValueError text. The table is
the specs of tests/test_progressive.py:71-147, then the grammar's other
errors. The rest of the progressive slice's tests are in
tests/test_torch_progressive.py.
"""

import dataclasses

import pytest

from dcgan_tpu import progressive as jprog
from dcgan_tpu.config import ModelConfig as JModelConfig
from dcgan_tpu_torch import progressive
from dcgan_tpu_torch.config import ModelConfig
from torch_jax_draws import one_torch_thread  # noqa: F401

BATCH = 8
MODEL = dict(gf_dim=8, df_dim=8, z_dim=8, compute_dtype="float32")


# (spec, output_size, parse_schedule keywords): the specs of
# tests/test_progressive.py:71-147, then the grammar's other errors
SPECS = [
    ("8:4,16:*", 16, {}), ("8:4:16,16:*:4", 16, {}), ("8:4,16:4", 16, {}),
    ("8:*,16:*", 16, {}), ("16:4,16:*", 16, {}), ("12:4,16:*", 16, {}),
    ("8:4,32:*", 16, {}), ("8:3,16:*", 16, {"steps_per_call": 2}),
    ("8:4,16:*", 16, {"steps_per_call": 2}),
    ("8:1000,16:*", 16, {"max_steps": 1000}),
    ("8:4,16:4,32:*", 32, {"steps_per_call": 2, "fade_steps": 2}),
    ("8:4,16:4,32:*", 32, {"fade_steps": 8}),
    ("8:2,16:2,32:*", 32, {}), ("8:2,16:*", 16, {"fade_steps": 4}),
    ("8:2:6,16:*", 16, {}),
    ("", 16, {}), (" , ", 16, {}), ("8,16:*", 16, {}),
    ("8:2:4:1,16:*", 16, {}), ("x:2,16:*", 16, {}), ("8:y,16:*", 16, {}),
    ("8:0,16:*", 16, {}), ("8:2:z,16:*", 16, {}), ("8:2:0,16:*", 16, {}),
    ("8:2:3,16:*", 16, {"grad_accum": 2}), ("4:2,16:*", 16, {}),
    ("8:2,16:*", 16, {"fade_steps": -1}),
    ("8:2,16:2,32:*", 32, {"fade_steps": 2, "grad_accum": 2}),
]


def _parse_both(spec, size, kw):
    """Each package's parse_schedule on the spec: (phases, fade) or the
    ValueError's text."""
    kw = dict(kw)
    max_steps = kw.pop("max_steps", 1000)
    out = []
    for parse, model in ((jprog.parse_schedule,
                          JModelConfig(output_size=size, **MODEL)),
                         (progressive.parse_schedule,
                          ModelConfig(output_size=size, **MODEL))):
        try:
            s = parse(spec, model=model, batch_size=BATCH,
                      max_steps=max_steps, **kw)
            out.append(([dataclasses.astuple(p) for p in s.phases],
                        s.fade_steps))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("spec,size,kw", SPECS)
def test_parse_matches_jax(spec, size, kw):
    jax_, port = _parse_both(spec, size, kw)
    assert port == jax_
