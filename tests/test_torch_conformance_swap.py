"""The conformance matrix's swap mode on the port (the attention,
encoder-decoder, rglru and third-party families; the moe and ssm
families are in ``test_torch_conformance_swap_moe_ssm.py``); the drives
and runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import (DRIVES, OTHER_FAMILIES, _store,
                                      reference_digest, run_kill)


@pytest.mark.parametrize("family", OTHER_FAMILIES)
def test_swap(family, tmp_path):
    """The full kill sequence under both store packages — swapping is
    one spec string — with digests identical across them."""
    dr = DRIVES[family]
    da = run_kill(dr, _store("localfs", tmp_path, "a"))
    db = run_kill(dr, _store("sharded", tmp_path, "b"))
    assert da == db == reference_digest(family)
