"""The conformance matrix's commit mode on the port (the moe and ssm
families); the drives and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import DRIVES, MOE_SSM, _store, run_commit


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", MOE_SSM)
def test_commit(family, backend, tmp_path):
    run_commit(DRIVES[family], _store(backend, tmp_path))
