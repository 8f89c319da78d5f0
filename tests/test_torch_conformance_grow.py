"""The conformance matrix's churn-grow and reslot modes on the port (every
family; reslot: the engines and the third-party app); the drives and
runners are in ``torch_conformance_drives``."""
import pytest

from torch_conformance_drives import (DRIVES, ENGINES, FAMILIES, _store,
                                      run_reslot, run_rl_reslot, run_shrink)


@pytest.mark.parametrize("family", FAMILIES)
def test_churn_grow(family, tmp_path):
    run_shrink(DRIVES[family], _store("localfs", tmp_path), grow=True)


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
@pytest.mark.parametrize("family", ENGINES + ["thirdparty"])
def test_reslot(family, backend, tmp_path):
    if family == "thirdparty":
        run_rl_reslot(_store(backend, tmp_path))
    else:
        run_reslot(DRIVES[family], _store(backend, tmp_path))
