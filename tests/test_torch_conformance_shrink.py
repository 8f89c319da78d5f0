"""The conformance matrix's shrink mode, the mid-chain entry and the
third-party reference on the port (every family); the drives and runners
are in ``torch_conformance_drives``."""
import pytest

from repro_torch.api import CheckpointSession, Policy
from torch_conformance_drives import (DRIVES, FAMILIES, _GrowingApp,
                                      _rl_digest, _store, reference_digest,
                                      run_shrink)


@pytest.mark.parametrize("family", FAMILIES)
def test_shrink(family, tmp_path):
    run_shrink(DRIVES[family], _store("replicated", tmp_path))


def test_thirdparty_reference_is_the_jax_examples():
    """The twin's uninterrupted digest, which every thirdparty mode is
    held to, is the JAX package's example's on the same steps."""
    assert reference_digest("thirdparty") == \
        _rl_digest(DRIVES["thirdparty"].total)


@pytest.mark.parametrize("backend", ["localfs", "sharded"])
def test_midchain(backend, tmp_path):
    """An entry first introduced mid-chain checkpoints and restores
    bit-identically, eager and streamed, through the public API alone."""
    ref = _GrowingApp()
    ref.advance(6)
    want = ref.digest()
    store = _store(backend, tmp_path)
    with CheckpointSession(store, Policy(interval=1, chain=8,
                                         keep_last=8)) as sess:
        app = sess.attach(_GrowingApp())
        for _ in range(4):
            app.advance(1)
            sess.maybe_snapshot()
        sess.wait()
        assert app.late is not None
        link = sess.backend.get_manifest(4)
        assert link.get("base_step") is not None and \
            link["entries"]["late"]["leaves"]["['z']"].get("mode") == "xor"
        del app                                   # hard kill
        for streaming in (False, True):
            app2 = sess.restore("latest", streaming=streaming)
            assert app2.step == 4
            app2.advance(2)
            got = app2.digest()
            assert got == want, (streaming, got, want)
