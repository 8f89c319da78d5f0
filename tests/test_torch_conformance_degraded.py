"""The conformance matrix's degraded mode on the port (every family); the
drives and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import DRIVES, FAMILIES, _store, run_degraded


@pytest.mark.parametrize("family", FAMILIES)
def test_degraded(family, tmp_path):
    run_degraded(DRIVES[family], _store("replicated", tmp_path, "d"))
