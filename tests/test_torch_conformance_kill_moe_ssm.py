"""The conformance matrix's kill mode on the port (the moe and ssm
families); the drives and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import DRIVES, MOE_SSM, _store, run_kill


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", MOE_SSM)
def test_kill(family, backend, tmp_path):
    run_kill(DRIVES[family], _store(backend, tmp_path))
