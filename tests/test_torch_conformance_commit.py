"""The conformance matrix's commit mode on the port (the attention,
encoder-decoder, rglru and third-party families; the moe and ssm
families are in ``test_torch_conformance_commit_moe_ssm.py``); the
drives and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import DRIVES, OTHER_FAMILIES, _store, run_commit


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", OTHER_FAMILIES)
def test_commit(family, backend, tmp_path):
    run_commit(DRIVES[family], _store(backend, tmp_path))
