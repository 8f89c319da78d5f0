"""The conformance matrix's kill mode on the port (the attention,
encoder-decoder, rglru and third-party families; the moe and ssm
families are in ``test_torch_conformance_kill_moe_ssm.py``); the drives
and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import DRIVES, OTHER_FAMILIES, _store, run_kill


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", OTHER_FAMILIES)
def test_kill(family, backend, tmp_path):
    run_kill(DRIVES[family], _store(backend, tmp_path))
