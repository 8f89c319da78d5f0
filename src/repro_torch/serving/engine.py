"""Serving: a continuous-batching engine whose live sessions are
checkpointable — the port of ``repro.serving.engine``.

The decode step is registered in the C/R function registry, so a
serving process restores through one ``core.incarnation.Incarnation``:
fresh lower half, replay binds the device, the decode step function and
a fresh (empty) cache, then the *complete* session state rebinds: cache
contents, request queue, per-slot in-flight requests (prompt, generated
tokens, budget), slot positions and pending tokens. This is the paper's
§IV demo — the artist reopens Maya and the scene is still there — for
inference sessions.

Restore is *elastic* in the serving dimension: a checkpoint taken on an
N-slot engine lands on an M-slot engine (re-slotting). Each live
session's decode state is rebuilt by replaying its full token history
(prompt + tokens generated so far) into its new slot: through a
batch-1 prefill for the attention families, through batch-1 decode
steps for the recurrent ones (ssm, hybrid), whose state padding would
corrupt.

The engine runs on one device: the CUDA card unless the caller passes
``device="cpu"``. Its KV cache is updated in place by every decode step
and admission (``models.layers``), never reallocated.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import register_app_kind
from repro_torch.api.app import RestoreContext
from repro_torch.api.errors import RestoreError
from repro_torch.configs import registry as cfg_registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core.oplog import CacheAlloc, Compile, OpLog
from repro_torch.core.split_state import (LowerHalf, UpperHalf,
                                          register_step_fn)
from repro_torch.host import resolve_device, to_tensor
from repro_torch.models import model as M
from repro_torch.tree import fill_like, tree_from_paths, tree_map


def _resolve_cfg(arch: str) -> ModelConfig:
    return cfg_registry.resolve_config(arch)


@register_step_fn("prefill_step")
def _build_prefill(arch, shape_key, plan_key, lower):
    """The prefill step function a logged ``Compile`` binds: the model's
    eager ``prefill`` for the arch — (params, tokens, cache) -> (last
    logits, cache filled in place)."""
    return functools.partial(M.prefill, _resolve_cfg(arch))


@register_step_fn("decode_step")
def _build_decode(arch, shape_key, plan_key, lower):
    """The decode step function a logged ``Compile`` binds: the model's
    eager ``decode_step`` for the arch — (params, cache, tokens, pos)."""
    return functools.partial(M.decode_step, _resolve_cfg(arch))


# ---------------------------------------------------------------------------
# continuous batching engine (host-side scheduler)
# ---------------------------------------------------------------------------

@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


def _request_tree(r: Request) -> Dict[str, np.ndarray]:
    """A Request as a checkpointable tree of arrays."""
    return {"rid": np.int64(r.rid), "max_new": np.int64(r.max_new),
            "prompt": np.asarray(r.prompt, np.int32),
            "out": np.asarray(r.out, np.int32)}


def _request_from_tree(t: Dict[str, Any]) -> Request:
    return Request(rid=int(t["rid"]), max_new=int(t["max_new"]),
                   prompt=np.asarray(t["prompt"], np.int32),
                   out=[int(x) for x in np.asarray(t["out"]).ravel()])


def _reslot_rewriter(n_old: int, n_new: int) -> Callable:
    """Op-log rewrite for elastic re-slotting: the logged CacheAlloc and
    decode Compile carry the old slot count; replay them at the new one
    (same virtual ids — the vid/handle indirection is what makes the
    rewrite invisible to everything above the table)."""
    def rewrite(op):
        if isinstance(op, CacheAlloc) and op.batch == n_old:
            return dataclasses.replace(op, batch=n_new)
        if isinstance(op, Compile) and op.fn_name == "decode_step":
            return dataclasses.replace(op, shape_key=re.sub(
                rf"_b{n_old}$", f"_b{n_new}", op.shape_key))
        return op
    return rewrite


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index in (None, device.index))


class ServingEngine:
    """Slot-based continuous batching over fixed-shape decode steps.

    Decode always runs the full slot batch; finished slots are refilled
    from the queue between steps. Admission rebuilds the slot's decode
    state from the request's full token history — prompt plus any tokens
    already generated, so a request resumed from a checkpoint re-enters
    mid-generation — through a batch-1 prefill of the history,
    right-padded into a power-of-two bucket (attention families), or a
    batch-1 decode replay of it (recurrent families, where the pad
    tokens would advance the state).
    """

    def __init__(self, cfg: ModelConfig, params, device, n_slots: int,
                 max_seq: int, manager=None, lower=None,
                 arch: Optional[str] = None,
                 _adopt: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        emb = params["tok_emb"]
        if not _on(emb, self.device):
            raise ValueError(f"params live on {emb.device}, the engine on "
                             f"{self.device}; move them first")
        self.arch = arch
        if _adopt is not None:
            # runtime resources already exist (built or replayed through
            # the logged lower half) — adopt instead of re-creating
            self.decode = _adopt["decode"]
            self.cache = _adopt["cache"]
            self.vexec = _adopt.get("vexec")
            self.vcache = _adopt.get("vcache")
        else:
            self.decode = functools.partial(M.decode_step, cfg)
            self.cache = M.init_cache(cfg, n_slots, max_seq, self.device)
            self.vexec = self.vcache = None
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.slot_tok = np.zeros((n_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.steps = 0
        self._prefill_admission = (cfg.family not in ("ssm", "hybrid")
                                   and not cfg.is_encoder_decoder)
        # the axis of each cache leaf that holds the slot index
        self._batch_axes = M.batch_axes(cfg)
        # optional live-session checkpointing (core.async_snapshot):
        # manager drains snapshots in the background, lower's op-log (if
        # the engine was built through the logged runtime) rides along so
        # a restore can replay CacheAlloc/Compile. The engine does NOT
        # hold a CheckpointSession of its own — one session owns an
        # app's lifecycle, and that session is the caller's.
        self.manager = manager
        self.lower = lower

    @classmethod
    def create(cls, arch: str, params, mesh_shape=(1, 1),
               mesh_axes=("data", "model"), *, n_slots: int, max_seq: int,
               manager=None, device=None) -> "ServingEngine":
        """Build an engine through the logged C/R runtime: MeshCreate +
        decode Compile + CacheAlloc all flow through a LowerHalf, so a
        snapshot of this engine carries the op-log a restore replays.
        ``device`` defaults to the CUDA card; pass ``"cpu"`` to run on
        the CPU."""
        dev = resolve_device(device)
        lower = LowerHalf(mesh_factory=lambda: dev)
        lower.mesh_create(mesh_shape, mesh_axes)
        vexec = lower.compile_step("decode_step", arch,
                                   f"decode_s{max_seq}_b{n_slots}")
        vcache = lower.cache_alloc(arch, n_slots, max_seq)
        return cls(_resolve_cfg(arch), params, lower.mesh, n_slots=n_slots,
                   max_seq=max_seq, manager=manager, lower=lower, arch=arch,
                   _adopt={"decode": lower.executable(vexec),
                           "cache": lower.cache(vcache),
                           "vexec": vexec, "vcache": vcache})

    # --- live-session checkpointing ------------------------------------

    def session_state(self) -> UpperHalf:
        """The engine's *complete* semantic (upper-half) state: cache
        contents, slot bookkeeping (positions + pending tokens), every
        in-flight request (prompt, generated tokens, budget, identity)
        and the waiting queue. Params are the trainer's job, not ours."""
        up = UpperHalf()
        up.register("kv_cache", "cache", self.cache)
        up.register("sessions", "sessions", {
            "slot_pos": np.array(self.slot_pos),
            "slot_tok": np.array(self.slot_tok),
        })
        sched: Dict[str, Dict[str, Any]] = {"queue": {}, "slots": {}}
        for i, r in enumerate(self.queue):
            sched["queue"][f"{i:06d}"] = _request_tree(r)
        for s, r in enumerate(self.slot_req):
            if r is not None:
                sched["slots"][f"{s:06d}"] = _request_tree(r)
        up.register("sched", "sched", sched)
        up.register("steps", "step", np.int64(self.steps))
        return up

    def job_meta(self) -> Dict[str, Any]:
        return {"kind": "serving", "arch": self.arch,
                "n_slots": self.n_slots, "max_seq": self.max_seq}

    # --- CheckpointableApp protocol (repro_torch.api) ------------------

    def checkpoint_state(self) -> UpperHalf:
        # session_state() is the dynamic hook the session prefers; this
        # satisfies the protocol's required method with the same answer
        return self.session_state()

    def checkpoint_step(self) -> int:
        return self.steps

    def runtime_log(self) -> OpLog:
        return self.lower.oplog if self.lower is not None else OpLog()

    def snapshot(self, block: bool = False):
        """Snapshot of live sessions at an engine-step boundary;
        non-blocking by default — decode keeps running while the
        pipeline encodes and writes. Returns the SnapshotHandle (None
        when blocking, or if dropped under "skip" backpressure)."""
        if self.manager is None:
            raise RuntimeError("construct the engine with manager= to "
                               "snapshot it")
        return self.manager.save(self.checkpoint_step(),
                                 self.session_state(), self.runtime_log(),
                                 block=block, job_meta=self.job_meta())

    # --- restore (the Incarnation lifecycle, serving flavor) -----------

    def bind(self, restore: RestoreContext) -> None:
        """CheckpointableApp.bind: rebind the *complete* session state —
        cache contents, slot bookkeeping, in-flight requests, waiting
        queue — from a materialized restore context. On a re-slot
        restore (this engine's slot count differs from the checkpoint's)
        the skipped cache/slot entries are rebuilt instead: every former
        in-flight session re-enters through admission, which replays its
        prompt + generated tokens into its new slot."""
        inc = restore.incarnation()
        reslot = self.n_slots != int(restore.job["n_slots"])
        self.steps = int(inc.scalar("steps")) if inc.has_entry("steps") \
            else 0

        sched = (tree_from_paths(inc.entry_paths("sched"))
                 if inc.has_entry("sched") else {})
        slot_reqs = [(int(k), _request_from_tree(v))
                     for k, v in sorted(sched.get("slots", {}).items())]
        queue_reqs = [_request_from_tree(v)
                      for _, v in sorted(sched.get("queue", {}).items())]

        if not reslot:
            host = fill_like(self.cache, inc.entry_paths("kv_cache"))
            tree_map(lambda t, v: t.copy_(to_tensor(v, t.dtype, t.device)),
                     self.cache, host)
            sess = tree_from_paths(inc.entry_paths("sessions"))
            self.slot_pos = np.asarray(sess["slot_pos"], np.int32).copy()
            self.slot_tok = np.asarray(
                sess["slot_tok"], np.int32).copy().reshape(self.n_slots, 1)
            for s, r in slot_reqs:
                self.slot_req[s] = r
            self.queue = queue_reqs
        else:
            # elastic re-slot: former in-flight sessions (slot order)
            # lead the queue, then the waiting requests; admission
            # replays each one's history into its new slot. Sessions
            # beyond the new slot count wait their turn — nothing drops.
            self.queue = [r for _, r in slot_reqs] + queue_reqs
            self._admit()
        inc.release()   # every entry is rebound or rebuilt; drop the
        self.incarnation = inc  # host payload, keep timings + manifest

    def live_requests(self) -> List[Request]:
        """In-flight requests (slot order) + the waiting queue."""
        return [r for r in self.slot_req if r is not None] + list(self.queue)

    def extract_sessions(self, slots: Optional[List[int]] = None, *,
                         include_queue: bool = False) -> List[Request]:
        """Freeze and REMOVE live sessions — the migration source hook.

        The chosen ``slots`` (None = every occupied slot) give up their
        requests; each request carries its complete history (prompt +
        generated tokens + budget), which is all a target engine needs
        to rebuild the session's KV state through admission replay — KV
        bytes never travel. The freed slots zero their bookkeeping and
        refill from the queue on the next step. ``include_queue`` also
        drains the waiting queue (a full drain of this engine)."""
        chosen = range(self.n_slots) if slots is None else slots
        out: List[Request] = []
        for s in chosen:
            if not 0 <= s < self.n_slots:
                raise IndexError(f"slot {s} out of range "
                                 f"(engine has {self.n_slots})")
            r = self.slot_req[s]
            if r is None:
                continue
            out.append(r)
            self.slot_req[s] = None
            self.slot_pos[s] = 0
            self.slot_tok[s, 0] = 0
        if include_queue:
            out.extend(self.queue)
            self.queue = []
        return out

    # --- admission ------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self._bind_slot(s, self.queue.pop(0))

    def _bind_slot(self, s: int, req: Request) -> None:
        """Admit ``req`` into slot ``s``, rebuilding the slot's decode
        state from the request's full token history. The last history
        token becomes the slot's pending token, so the next engine step
        produces the request's next output token."""
        seq = np.concatenate([np.asarray(req.prompt).ravel(),
                              np.asarray(req.out).ravel()]).astype(np.int32)
        hist = seq[:-1]
        if len(hist):
            if self._prefill_admission:
                self._prefill_slot(s, hist)
            else:
                self._merge_slot(s, self.replay(hist)[1])
        self.slot_req[s] = req
        self.slot_tok[s, 0] = int(seq[-1])
        self.slot_pos[s] = len(seq) - 1

    def _prefill_slot(self, s: int, hist: np.ndarray) -> None:
        """One batch-1 prefill call instead of O(len) full-slot decodes:
        the history is right-padded into a power-of-two bucket and
        prefilled into a fresh single-slot cache, which then lands in
        slot ``s``. Pad garbage beyond the history writes cache entries
        at positions the causal mask hides until decode overwrites them
        (each decode step rewrites its own position before attending)."""
        width = max(8, 1 << (int(len(hist)) - 1).bit_length())
        width = min(width, self.max_seq)
        if len(hist) > width:
            raise ValueError(f"history of {len(hist)} tokens does not fit "
                             f"max_seq={self.max_seq}")
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(hist)] = hist
        one = M.init_cache(self.cfg, 1, self.max_seq, self.device)
        M.prefill(self.cfg, self.params,
                  torch.tensor(toks, device=self.device), one)
        self._merge_slot(s, one)

    def replay(self, hist: np.ndarray):
        """Recurrent families (ssm, hybrid): the state is order-sensitive,
        so no padding — replay the history through batch-1 decode steps
        into a fresh single-slot cache (no other slot's state moves).
        Returns (the last step's logits [1, V], the single-slot cache)."""
        one = M.init_cache(self.cfg, 1, self.max_seq, self.device)
        logits = None
        for i, t in enumerate(np.asarray(hist).ravel()):
            logits, one = M.decode_step(
                self.cfg, self.params, one,
                torch.tensor([[int(t)]], dtype=torch.int32,
                             device=self.device),
                torch.tensor([i], dtype=torch.int32, device=self.device))
        return logits, one

    def _merge_slot(self, s: int, one) -> None:
        """Land a single-slot cache in slot ``s`` of the engine cache, in
        place, along each leaf's batch axis (``M.batch_axes``)."""
        tree_map(lambda full, sl, ax: full.narrow(ax, s, 1).copy_(sl),
                 self.cache, one, self._batch_axes)

    def step(self) -> int:
        """One engine iteration; returns #active slots."""
        self._admit()
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return 0
        toks = torch.tensor(self.slot_tok, device=self.device)
        poss = torch.tensor(self.slot_pos, device=self.device)
        logits, self.cache = self.decode(self.params, self.cache, toks, poss)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.slot_tok[s, 0] = tok
            self.slot_pos[s] += 1
            if len(req.out) >= req.max_new or self.slot_pos[s] >= self.max_seq - 1:
                req.done = True
                self.slot_req[s] = None
        self.steps += 1
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000,
                          snapshot_every: Optional[int] = None) -> None:
        while (self.queue or any(self.slot_req)) and max_steps > 0:
            self.step()
            if snapshot_every and self.steps % snapshot_every == 0 \
                    and self.manager is not None:
                self.snapshot()
            max_steps -= 1
        if snapshot_every and self.manager is not None:
            self.manager.wait()


@register_app_kind("serving")
def _restore_engine(restore: RestoreContext, params,
                    n_slots: Optional[int] = None,
                    device=None) -> ServingEngine:
    """The "serving" restore binder: the Incarnation lifecycle, serving
    flavor. ``device`` is where the engine comes back (default: the
    card). On a re-slot restore the checkpoint's KV cache and slot
    bookkeeping are rebuilt from scratch, so their delta chains — the
    bulk of the payload — are skipped at decode, not decoded and
    dropped; the op-log replays with CacheAlloc/Compile rewritten to
    the new slot count (composed with any session-level rewrite)."""
    job = restore.job
    arch = job.get("arch")
    if arch is None:
        raise RestoreError("checkpoint predates engine arch metadata; "
                           "cannot rebuild the engine from it")
    n_old, max_seq = int(job["n_slots"]), int(job["max_seq"])
    n_new = int(n_slots) if n_slots is not None else n_old
    reslot = n_new != n_old

    rewriters = [r for r in (restore.rewrite_op,
                             _reslot_rewriter(n_old, n_new) if reslot
                             else None) if r is not None]
    rewrite = None
    if rewriters:
        rewrite = rewriters[0] if len(rewriters) == 1 else \
            (lambda op: rewriters[1](rewriters[0](op)))
    dev = None if restore.mesh_factory is not None \
        else resolve_device(device)
    mesh_factory = restore.mesh_factory or (lambda: dev)

    inc = restore.incarnation(
        skip_entries=("kv_cache", "sessions") if reslot else None,
        rewrite_op=rewrite, mesh_factory=mesh_factory)
    inc.materialize()
    lower = inc.build_lower()
    cfg = _resolve_cfg(arch)
    use_device = inc.mesh_or_none() or dev
    if use_device is None:
        raise RestoreError("op-log bound no device (engine was built "
                           "outside the logged runtime); pass device=")
    vexec = inc.last_compile("decode_step")
    adopt = None
    if vexec is not None:
        vcache = inc.last_cache_alloc()
        adopt = {"decode": lower.executable(vexec),
                 "cache": (lower.cache(vcache) if vcache is not None
                           else M.init_cache(cfg, n_new, max_seq,
                                             use_device)),
                 "vexec": vexec, "vcache": vcache}
    eng = ServingEngine(cfg, params, use_device, n_slots=n_new,
                        max_seq=max_seq, manager=restore.manager,
                        lower=lower, arch=arch, _adopt=adopt)
    eng.bind(restore)
    return eng
