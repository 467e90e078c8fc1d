"""Continued from test_torch_hygiene.py: share 2 of 4 of
`test_ast_imports`, which holds every file of the port, chip_smoke.py,
tools/chaos_drill_torch.py and tools/trace_summary_torch.py to importing
nothing of jax, jaxlib or dcgan_tpu."""

import pytest

from test_torch_hygiene import check_imports, import_shard, port_file_id
from torch_jax_draws import one_torch_thread  # noqa: F401


class TestNoJaxImports:
    @pytest.mark.parametrize("path", import_shard(1), ids=port_file_id)
    def test_ast_imports(self, path):
        check_imports(path)
