from repro_torch.core.backends.base import CheckpointBackend
from repro_torch.core.backends.localfs import LocalFSBackend

# the JAX package's sharded: and cached: stores wait for ROADMAP A3
BACKENDS = {"localfs": LocalFSBackend}


def make_backend(kind: str, root: str, **kw) -> CheckpointBackend:
    return BACKENDS[kind](root, **kw)
