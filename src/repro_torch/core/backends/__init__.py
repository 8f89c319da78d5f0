from repro_torch.core.backends.base import CheckpointBackend
from repro_torch.core.backends.cached import CachedBackend
from repro_torch.core.backends.localfs import LocalFSBackend
from repro_torch.core.backends.sharded import ShardedBackend

BACKENDS = {"localfs": LocalFSBackend, "sharded": ShardedBackend,
            "cached": CachedBackend}


def make_backend(kind: str, root: str, **kw) -> CheckpointBackend:
    return BACKENDS[kind](root, **kw)
