"""URI-addressed registries: storage backends, codecs, and app kinds.

The paper's §V claim — the same split-process design serves multiple
checkpoint packages without the application caring — becomes literal
here: a backend is a *string* (``localfs:/path`` is the CRIU-analogue,
``sharded:/path?hosts=4&replicate=1`` the DMTCP-analogue), and swapping
packages is a one-string change at the call site. Third-party backends
register a factory under a new scheme without touching ``repro_torch.core``:

    @register_backend("s3")
    def _s3(path, *, region="us-east-1"):
        return S3Backend(path, region=region)

App kinds close the same loop on the restore side: a checkpoint's
``job_meta()["kind"]`` names the binder that rebuilds the application
from a ``RestoreContext``, so ``CheckpointSession.restore`` works for
any workload that registered itself — the trainer, the serving engine,
and anything a user writes against the protocol alone.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Dict, Tuple

from repro_torch.api.errors import PolicyError

# ---------------------------------------------------------------------------
# backends: scheme -> factory(path, **params)
# ---------------------------------------------------------------------------

BACKEND_SCHEMES: Dict[str, Callable[..., Any]] = {}


def _registrant(fn: Callable) -> str:
    mod = getattr(fn, "__module__", None) or "?"
    name = getattr(fn, "__qualname__", None) or repr(fn)
    return f"{mod}.{name}"


def register_backend(scheme: str, *, replace: bool = False) -> Callable:
    """Register ``factory(path, **params) -> CheckpointBackend`` under a
    URI scheme. Query parameters arrive as strings; the factory owns
    their conversion (raise ``PolicyError`` on a bad value).

    A scheme is a global name: registering a *different* factory under a
    taken scheme raises ``PolicyError`` instead of silently shadowing
    whoever got there first (re-registering the same callable — e.g. a
    module reimported under test — is a no-op). Pass ``replace=True`` to
    override deliberately."""
    def deco(factory: Callable) -> Callable:
        existing = BACKEND_SCHEMES.get(scheme)
        if existing is not None and existing is not factory and not replace:
            raise PolicyError(
                f"backend scheme {scheme!r} is already registered by "
                f"{_registrant(existing)}; pick a different scheme, or "
                f"pass register_backend({scheme!r}, replace=True) to "
                "override it deliberately")
        BACKEND_SCHEMES[scheme] = factory
        return factory
    return deco


def parse_store_spec(spec: str) -> Tuple[str, str, Dict[str, str]]:
    """``scheme:/path?k=v&...`` -> (scheme, path, params).

    One key is special: ``over=`` swallows the *rest of the query
    string* verbatim, so a whole nested store spec — query and all —
    can ride inside another one (``cached:/ssd?over=sharded:/remote?
    hosts=4&replicate=1``). That makes ``over`` necessarily the last
    parameter of its level; the outer split already stops at the first
    ``?``, so the nested spec's own ``?`` and ``&`` survive intact.

    Raises ``PolicyError`` with the expected shape spelled out — a store
    spec is user-facing configuration, so the error must be actionable.
    """
    shape = ("a store spec looks like 'scheme:/path[?key=value&...]', "
             f"e.g. 'localfs:/tmp/job' (known schemes: "
             f"{sorted(BACKEND_SCHEMES)})")
    if not isinstance(spec, str) or ":" not in spec:
        raise PolicyError(f"malformed backend spec {spec!r}: {shape}")
    scheme, rest = spec.split(":", 1)
    path, _, query = rest.partition("?")
    if not scheme or not path:
        raise PolicyError(f"malformed backend spec {spec!r}: {shape}")
    params: Dict[str, str] = {}
    if query:
        pieces = query.split("&")
        for i, piece in enumerate(pieces):
            key, eq, value = piece.partition("=")
            if not key or not eq:
                raise PolicyError(
                    f"malformed backend spec {spec!r}: query piece "
                    f"{piece!r} is not 'key=value'; {shape}")
            if key == "over":
                params[key] = "&".join([value] + pieces[i + 1:])
                break
            params[key] = value
    return scheme, path, params


def resolve_backend(spec: str, defaults: Dict[str, str] = None):
    """Build a backend from a store spec through the scheme registry."""
    scheme, path, params = parse_store_spec(spec)
    factory = BACKEND_SCHEMES.get(scheme)
    if factory is None:
        raise PolicyError(
            f"unknown backend scheme {scheme!r} in {spec!r} (known: "
            f"{sorted(BACKEND_SCHEMES)}); register a factory with "
            "repro_torch.api.register_backend")
    merged = dict(defaults or {})
    merged.update(params)
    sig = inspect.signature(factory)
    accepts_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    allowed = {n for n, p in sig.parameters.items()
               if p.kind in (inspect.Parameter.KEYWORD_ONLY,
                             inspect.Parameter.POSITIONAL_OR_KEYWORD)}
    allowed.discard("path")
    unknown = sorted(set(params) - allowed) if not accepts_kw else []
    if unknown:
        raise PolicyError(
            f"backend spec {spec!r}: unknown parameter(s) {unknown}; "
            f"{scheme!r} accepts {sorted(allowed)}")
    if not accepts_kw:
        merged = {k: v for k, v in merged.items() if k in allowed}
    return factory(path, **merged)


def _as_int(spec_key: str, value) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        raise PolicyError(
            f"store parameter {spec_key}={value!r} must be an integer")


def _as_bool(spec_key: str, value) -> bool:
    if isinstance(value, bool):
        return value
    v = str(value).lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise PolicyError(
        f"store parameter {spec_key}={value!r} must be a boolean "
        "(1/0/true/false)")


@register_backend("localfs")
def _localfs_backend(path: str, *, fsync="1"):
    """CRIU-analogue: one image directory, atomic-rename commits."""
    from repro_torch.core.backends.localfs import LocalFSBackend
    return LocalFSBackend(path, fsync=_as_bool("fsync", fsync))


@register_backend("sharded")
def _sharded_backend(path: str, *, hosts="4", replicate="0", writers="4",
                     fsync="1"):
    """DMTCP-analogue: blobs hashed to N virtual hosts, coordinator
    manifest, optional peer replication."""
    from repro_torch.core.backends.sharded import ShardedBackend
    n_hosts = _as_int("hosts", hosts)
    n_writers = _as_int("writers", writers)
    # range checks here, not deep in the write pipeline: hosts=0 would
    # surface as a modulo-by-zero at the first blob hash, writers=0 as
    # a raw ThreadPoolExecutor ValueError
    if n_hosts < 1:
        raise PolicyError(f"store parameter hosts={n_hosts} must be >= 1")
    if n_writers < 1:
        raise PolicyError(
            f"store parameter writers={n_writers} must be >= 1")
    return ShardedBackend(path, n_hosts=n_hosts,
                          replicate=_as_bool("replicate", replicate),
                          writers=n_writers,
                          fsync=_as_bool("fsync", fsync))


@register_backend("cached")
def _cached_backend(path: str, *, over="", fsync="0"):
    """Local read-through blob cache over any other registered store:
    ``cached:/ssd-cache?over=sharded:/remote?hosts=4``. Reads hit the
    local tier first and warm it on a miss; writes go through to the
    inner store and warm the cache."""
    from repro_torch.core.backends.cached import CachedBackend
    if not over:
        raise PolicyError(
            "store scheme 'cached:' needs the store it caches: "
            "'cached:/local-cache?over=<inner spec>', e.g. "
            "'cached:/ssd/cache?over=sharded:/remote?hosts=4' (over= "
            "swallows the rest of the spec, so it must come last)")
    return CachedBackend(path, resolve_backend(over),
                         fsync=_as_bool("fsync", fsync))


# ---------------------------------------------------------------------------
# codecs: per-entry-kind payload encodings (delta.CODECS is the store)
# ---------------------------------------------------------------------------

def register_codec(name: str, encode: Callable, decode: Callable) -> None:
    """Register a payload codec usable from ``Policy(codecs={kind: name})``.

    ``encode(array) -> {part_name: bytes-like}``; ``decode(parts, dtype,
    shape) -> np.ndarray`` — the same contract as the built-in ``int8``
    moment-quantization codec in ``core.delta``."""
    from repro_torch.core import delta
    delta.CODECS[name] = (encode, decode)


def available_codecs():
    from repro_torch.core import delta
    return sorted(delta.CODECS)


# ---------------------------------------------------------------------------
# app kinds: job_meta()["kind"] -> binder(RestoreContext, **kw) -> app
# ---------------------------------------------------------------------------

APP_KINDS: Dict[str, Callable[..., Any]] = {}

# Built-in kinds resolve lazily: repro_torch.api must not import the app
# modules at load time (they import repro_torch.api), so the module that owns
# each built-in binder is imported on first restore of that kind.
_LAZY_KINDS = {
    "serving": "repro_torch.serving.engine",
    "train": "repro_torch.train.loop",
}


def register_app_kind(kind: str, *, replace: bool = False) -> Callable:
    """Register the restore binder for a checkpoint kind. The binder
    receives a ``RestoreContext`` (plus any kwargs the caller passed to
    ``CheckpointSession.restore``) and returns the rebuilt app.

    A kind names a manifest format, so collisions are real bugs:
    registering a *different* binder under a taken kind — including the
    built-in lazy kinds, whether or not their module has loaded yet —
    raises ``PolicyError`` instead of silently shadowing the first
    registrant (re-registering the same callable is a no-op). Pass
    ``replace=True`` to override deliberately; a replaced built-in stays
    replaced even if its home module is imported later."""
    def deco(binder: Callable) -> Callable:
        home = _LAZY_KINDS.get(kind)
        if home is not None and getattr(binder, "__module__", None) == home:
            # the built-in module registering its own binder: first load
            # wins, but never clobber a deliberate replace=True override
            APP_KINDS.setdefault(kind, binder)
            return binder
        existing = APP_KINDS.get(kind)
        clash = (existing is not None and existing is not binder) \
            or (existing is None and home is not None)
        if clash and not replace:
            owner = (_registrant(existing) if existing is not None
                     else f"the built-in binder in {home}")
            raise PolicyError(
                f"app kind {kind!r} is already registered by {owner}; "
                f"pick a different kind, or pass register_app_kind("
                f"{kind!r}, replace=True) to override it deliberately")
        APP_KINDS[kind] = binder
        return binder
    return deco


def resolve_app_kind(kind: str) -> Callable:
    if kind not in APP_KINDS and kind in _LAZY_KINDS:
        importlib.import_module(_LAZY_KINDS[kind])
    try:
        return APP_KINDS[kind]
    except KeyError:
        raise PolicyError(
            f"no CheckpointableApp binder registered for checkpoint "
            f"kind {kind!r} (known: {sorted(set(APP_KINDS) | set(_LAZY_KINDS))}); "
            "import the module that defines the app or register one "
            "with repro_torch.api.register_app_kind") from None
