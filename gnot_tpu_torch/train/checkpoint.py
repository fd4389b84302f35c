"""Checkpoints of a training run: ``best`` and ``latest``, saved in the
background, restored through a fallback walk.

The port of ``gnot_tpu/train/checkpoint.py``'s protocol in the port's own
format. Each save is one ``torch.save`` file named for its epoch,
``<dir>/<name>.<epoch>.pt`` (``<name>.<epoch>r<tick>.pt`` when a resumed
run saves an epoch again whose file the sidecar still names), holding
``{"state", "epoch", "best_metric", "meta"}``, where ``state`` is
``Trainer.state_dict()`` in the trainer's own parameter layout and
``meta`` the ``extra_meta`` provenance. Beside it, the ``<name>.json``
sidecar ``{epoch, best_metric, dir, **extra_meta}`` names the committed
file (``dir``, the JAX sidecar's key).

Crash safety: a save writes a temporary file and renames it over its own
fresh name, never over a committed file; the sidecar is written
(temporary file, then ``os.replace``) only after the file it names is
committed, and the files it supersedes are pruned only then. A crash
anywhere leaves the old sidecar naming the old, whole file.

Saves are asynchronous: ``save_*`` waits for the previous save (and
publishes it), takes a copy of the state the trainer can no longer
mutate (on the card, a copy into page-locked host memory queued on the
stream, with an event the writer waits on; on the CPU, a clone), and
writes it on a background thread while training goes on. ``wait()``
blocks until the write is committed and publishes its sidecar.

I/O hardening: save kickoffs, restore reads and sidecar writes go through
``_io``, which retries transient OSErrors with exponential backoff and
jitter (``resilience/retry.py``) and fires the fault injector's
``ckpt_io`` errors inside each attempt; a retry is an ``io_retry`` event.
A restore walks a chain of candidates: the file the sidecar names, then
every other ``<name>.*.pt`` newest first (``restore_latest`` then walks
``best``'s chain), skipping a missing file and moving on past one that
fails to load, so a truncated file, a lost sidecar or a sidecar naming a
deleted file falls back to an older checkpoint. Which one restored is
printed, kept in ``last_restore`` (the run manifest's ``restore`` field)
and emitted as a ``restore`` or ``restore_fallback`` event.

On a multi-rank run (``parallel/multihost.py``) the trainer hands every
save the whole state, gathered from the ranks' shards; rank 0 writes it
(the other ranks' saves are no-ops), so the file is the single-device
layout. Every rank restores the same file and keeps its shards (a
``local`` checkpointer's walk is its rank's alone: serving's rank 0). The
restore walk agrees across ranks, as JAX's does across hosts: the ranks
meet before the walk (rank 0's save in flight is then published), agree on
each candidate (``all_agree``) and on its outcome (``sync_flag``: one
rank's failed read fails the candidate for all), and on running out; a
divergence raises on every rank instead of leaving ranks on different
weights.

A file is read whole under the retry policy, then parsed with
``torch.load(weights_only=True)`` onto the CPU (a parse error walks on);
``Trainer.load_state_dict`` moves each tensor to its parameter's device.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import threading
from pathlib import Path
from typing import Any, Callable

import torch

from gnot_tpu_torch.obs import events
from gnot_tpu_torch.parallel import multihost
from gnot_tpu_torch.resilience.retry import RetryPolicy, retry_io

logger = logging.getLogger(__name__)


def host_copy(state) -> tuple[Any, "torch.cuda.Event | None"]:
    """A copy of a state_dict tree in host memory the caller owns, and the
    CUDA event after which it holds the values (None when nothing was on
    the card). A CUDA tensor is copied into new page-locked memory with
    ``non_blocking=True``: the copy is queued on the current stream after
    the kernels that wrote the tensor and before any later step's, and the
    host does not wait for it. A CPU tensor is cloned."""
    on_card = False

    def copy(node):
        nonlocal on_card
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                on_card = True
                out = torch.empty(node.shape, dtype=node.dtype, pin_memory=True)
                return out.copy_(node.detach(), non_blocking=True)
            return node.detach().clone()
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(copy(v) for v in node)
        return node

    owned = copy(state)
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    return owned, ready


class _Write:
    """One save in flight: a thread that waits for the host copy, then
    writes ``payload`` to a temporary file and renames it to ``path``,
    retrying transient errors. Its retries and its error are read by the
    main thread when it joins."""

    def __init__(self, path: str, payload: dict, ready, policy: RetryPolicy, op: str):
        self.path, self.payload, self.ready = path, payload, ready
        self.policy, self.op = policy, op
        self.retries: list[tuple[int, BaseException]] = []
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, name=f"checkpoint-{op}")
        self.thread.start()

    def _commit(self) -> None:
        tmp = os.path.join(os.path.dirname(self.path),
                           f".{os.path.basename(self.path)}.tmp{os.getpid()}")
        try:
            torch.save(self.payload, tmp)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _run(self) -> None:
        try:
            if self.ready is not None:
                self.ready.synchronize()
            retry_io(self._commit, policy=self.policy, describe=self.op,
                     on_retry=lambda n, exc: self.retries.append((n, exc)))
        except BaseException as exc:  # noqa: BLE001 — re-raised by the joiner
            self.error = exc


class Checkpointer:
    #: Committed checkpoint files: ``<name>.<epoch>.pt`` plus the resume-
    #: replay uniquifier (``latest.3.pt``, ``latest.3r1.pt``, ...).
    _FILE_RE = re.compile(r"^(?P<name>[a-z]+)\.(?P<epoch>\d+)(?:r(?P<tick>\d+))?\.pt$")

    def __init__(
        self,
        directory: str,
        extra_meta: dict | None = None,
        *,
        fault_injector=None,
        retry_policy: RetryPolicy | None = None,
        on_event: Callable[..., None] | None = None,
        local: bool = False,
    ):
        """``extra_meta`` is provenance recorded in every sidecar and file:
        ``main.py`` records the resolved numerics (``gelu``,
        ``attention_mode``, ``dtype``) and the state layout
        (``flat_params``), and a restore warns on a mismatch with this
        run's. ``fault_injector`` fires its ``ckpt_io`` errors inside each
        I/O attempt and its ``corrupt_ckpt`` after a publish; ``on_event``
        (the sink's ``log``) gets the ``io_retry``, ``restore`` and
        ``restore_fallback`` events. ``local`` makes every restore walk
        this rank's alone, agreeing with no other rank: serving over a mesh
        (``serve/mesh_serve.py``), where rank 0 restores and sends the
        weights to the ranks that wait for its next operation."""
        self.directory = os.path.abspath(directory)
        self.local = local
        os.makedirs(self.directory, exist_ok=True)
        self.extra_meta = dict(extra_meta or {})
        self.fault_injector = fault_injector
        self.retry_policy = retry_policy or RetryPolicy()
        self.on_event = on_event
        self.last_restore: dict | None = None
        # Saves whose sidecar is not yet written: (name, meta, file name).
        self._pending: list[tuple[str, dict, str]] = []
        # The file each name's sidecar names, as this process published it.
        self._published: dict[str, str] = {}
        self._write: _Write | None = None
        self._skipped: list[str] = []  # the last walk's failed candidates

    def path(self, name: str) -> Path:
        """The committed file ``<name>.json`` names (after any save in
        flight is published); FileNotFoundError when there is none."""
        self.wait()
        meta = self._read_sidecar(name)
        if meta is None or "dir" not in meta:
            raise FileNotFoundError(f"no '{name}' sidecar under {self.directory}")
        return Path(self.directory) / meta["dir"]

    # -- hardened I/O ------------------------------------------------------

    def _note_retry(self, op: str, attempt: int, exc: BaseException) -> None:
        if self.on_event is not None:
            self.on_event(event=events.IO_RETRY, op=op, attempt=attempt, error=str(exc))

    def _io(self, op: str, fn, *, deadline: float | None = None):
        """One checkpoint-I/O operation under the retry policy, the fault
        injector firing inside each attempt, so an injected transient
        error takes the backoff path a real one does. ``deadline``
        (absolute ``time.monotonic``) clamps the backoff sleeps."""

        def attempt():
            if self.fault_injector is not None:
                self.fault_injector.maybe_io_error(op)
            return fn()

        return retry_io(
            attempt, policy=self.retry_policy, describe=op,
            on_retry=lambda n, exc: self._note_retry(op, n, exc), deadline=deadline,
        )

    # -- commit protocol ---------------------------------------------------

    def _join(self) -> None:
        """Wait for the save in flight; emit its retries; re-raise its
        error, dropping its unpublished sidecar."""
        write, self._write = self._write, None
        if write is None:
            return
        write.thread.join()
        for attempt, exc in write.retries:
            self._note_retry(write.op, attempt, exc)
        if write.error is not None:
            self._pending = [p for p in self._pending
                             if os.path.join(self.directory, p[2]) != write.path]
            raise write.error

    def _flush_pending(self) -> None:
        """Publish the sidecars of committed saves and prune the files they
        supersede. Call only after ``_join``: every pending file is then
        committed on disk."""
        for name, meta, filename in self._pending:
            self._published[name] = filename
            meta_path = os.path.join(self.directory, f"{name}.json")

            def write_sidecar(meta_path=meta_path, meta=meta):
                tmp = f"{meta_path}.tmp"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, meta_path)

            self._io(f"sidecar:{name}", write_sidecar)
            if self.fault_injector is not None:
                # corrupt_ckpt@EPOCH fires once the file is committed and
                # published: the torn-write shape the walk must survive.
                self.fault_injector.post_save(
                    name, os.path.join(self.directory, filename), int(meta.get("epoch", -1)))
            for f in os.listdir(self.directory):
                m = self._FILE_RE.match(f)
                if m is not None and m.group("name") == name and f != filename:
                    os.remove(os.path.join(self.directory, f))
        self._pending.clear()

    def _save(self, name: str, state: Any, epoch: int, best_metric: float) -> None:
        """Wait for the previous save (and publish it), copy ``state`` out
        of the trainer's reach, and write it in the background. Rank 0
        only on a multi-rank run."""
        if multihost.process_index() != 0:
            return
        self._join()
        self._flush_pending()
        owned, ready = host_copy(state)
        filename = f"{name}.{epoch}.pt"
        # A resumed run can save an epoch again whose file the published
        # sidecar names: writing over it would destroy the committed
        # checkpoint before the new one commits, so uniquify instead.
        published = self._published.get(name)
        if published is None:
            meta = self._read_sidecar(name)
            if meta is not None and "dir" in meta:
                published = self._published[name] = meta["dir"]
        tick = 0
        while filename == published:
            tick += 1
            filename = f"{name}.{epoch}r{tick}.pt"
        payload = {"state": owned, "epoch": int(epoch), "best_metric": float(best_metric),
                   "meta": dict(self.extra_meta)}
        op = f"save:{name}"

        def kickoff():
            self._write = _Write(os.path.join(self.directory, filename), payload, ready,
                                 self.retry_policy, op)

        self._io(op, kickoff)
        meta = {"epoch": int(epoch), "best_metric": float(best_metric), "dir": filename}
        meta.update(self.extra_meta)
        self._pending.append((name, meta, filename))

    def wait(self) -> None:
        """Block until the save in flight is committed, and publish it."""
        self._join()
        self._flush_pending()

    def save_best(self, state: Any, epoch: int, best_metric: float) -> None:
        self._save("best", state, epoch, best_metric)

    def save_latest(self, state: Any, epoch: int, best_metric: float) -> None:
        """``epoch`` is the first epoch a resumed run trains."""
        self._save("latest", state, epoch, best_metric)

    # -- restore -----------------------------------------------------------

    def _read_sidecar(self, name: str) -> dict | None:
        meta_path = os.path.join(self.directory, f"{name}.json")
        try:
            with open(meta_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as exc:
            # A torn or unreadable sidecar is itself a corruption shape:
            # fall through to the file scan.
            logger.warning("unreadable sidecar %s (%s); scanning files", meta_path, exc)
            return None

    def _candidates(self, name: str) -> list[tuple[str, dict, str]]:
        """Restore candidates for ``name`` in trust order, as ``(path,
        meta, via)``: the file the sidecar names (a newer unpublished file
        may be a torn commit), then every other ``<name>.*.pt`` newest
        first, whose epoch comes from the file name and whose best metric
        degrades to +inf (the next eval re-establishes it)."""
        cands: list[tuple[str, dict, str]] = []
        meta = self._read_sidecar(name)
        sidecar_file = None
        if meta is not None:
            sidecar_file = meta.get("dir", f"{name}.pt")
            cands.append((os.path.join(self.directory, sidecar_file), meta, "sidecar"))
        try:
            entries = os.listdir(self.directory)
        except OSError:
            entries = []
        scanned = []
        for f in entries:
            m = self._FILE_RE.match(f)
            if (m is None or m.group("name") != name or f == sidecar_file
                    or not os.path.isfile(os.path.join(self.directory, f))):
                continue
            scanned.append((int(m.group("epoch")), int(m.group("tick") or 0), f))
        for epoch, _, f in sorted(scanned, reverse=True):
            cands.append((os.path.join(self.directory, f),
                          {"epoch": epoch, "best_metric": float("inf")}, "scan"))
        return cands

    def _restore(self, name: str, *, requested: str | None = None,
                 requested_skipped: list[str] | None = None, deadline: float | None = None):
        """Walk the candidate chain: the first file that loads (under the
        retry policy) wins. ``requested`` names the checkpoint the caller
        asked for when this walk is already a fallback (``restore_latest``
        walking on to ``best``), so one event describes the whole restore;
        ``requested_skipped`` (a key JAX's record lacks) then lists that
        name's candidates that failed. Returns ``(state, epoch,
        best_metric)`` or None, leaving the skips in ``_skipped``."""
        requested = requested or name
        self.wait()
        multiproc = multihost.process_count() > 1 and not self.local
        if multiproc:
            # Every rank past its wait: rank 0's last save is published.
            multihost.sync_flag(False)
        tried: list[str] = []
        self._skipped = tried
        for path, meta, via in self._candidates(name):
            filename = os.path.basename(path)
            if not os.path.isfile(path):
                # A sidecar naming a deleted file: on to the scan.
                tried.append(f"{filename} (missing file)")
                continue
            if multiproc and not multihost.all_agree(f"{name}:{filename}"):
                # Ranks that read different candidates would train on
                # different weights: agree on the candidate first.
                raise RuntimeError(
                    f"checkpoint restore walk diverged across hosts "
                    f"(this host chose {filename!r} for {name!r}); "
                    "per-host I/O failures left hosts seeing "
                    "different candidates — refusing the collective "
                    "restore that would hang the pod"
                )
            layout_conflict = via == "sidecar" and self._warn_numerics(name, meta)
            state, failure = None, None
            try:
                # The read is I/O and retried; the parse is content, and a
                # file that does not parse is corrupt, not flaky.
                raw = self._io(f"restore:{name}", Path(path).read_bytes, deadline=deadline)
                payload = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
                state = payload["state"]
            except Exception as exc:  # noqa: BLE001 — any load failure walks on
                if layout_conflict:
                    # A flat/tree layout mismatch is the run's config, not
                    # corruption: every candidate shares it.
                    raise
                failure = exc
            if multiproc and multihost.sync_flag(failure is not None):
                # Outcome agreement: if ANY rank failed this candidate,
                # every rank discards it and walks on together.
                failure = failure or RuntimeError(
                    "another host failed to restore this candidate")
            if failure is not None:
                tried.append(f"{filename} ({type(failure).__name__}: {failure})")
                logger.warning("restore of %s checkpoint %s failed (%s); trying next candidate",
                               name, filename, failure)
                continue
            fallback = via != "sidecar" or bool(tried) or requested != name
            self.last_restore = {
                "requested": requested,
                "name": name,
                "dir": filename,
                "epoch": int(meta["epoch"]),
                "best_metric": float(meta["best_metric"]),
                "fallback": fallback,
                "skipped": tried,
            }
            if requested != name:
                self.last_restore["requested_skipped"] = list(requested_skipped or [])
            if multihost.process_index() == 0:
                print(f"Restored '{name}' checkpoint from {filename} (epoch {int(meta['epoch'])})"
                      + (f" after skipping: {'; '.join(tried)}" if tried else ""))
            if self.on_event is not None:
                self.on_event(event=events.RESTORE_FALLBACK if fallback else events.RESTORE,
                              **self.last_restore)
            return state, int(meta["epoch"]), float(meta["best_metric"])
        if multiproc and not multihost.all_agree(f"{name}:<exhausted>"):
            # A rank that ran out of candidates while another still has one.
            raise RuntimeError(
                f"checkpoint restore walk diverged across hosts: this "
                f"host exhausted every '{name}' candidate while others "
                "still see one — refusing the collective restore that "
                "would hang the pod"
            )
        if tried and multihost.process_index() == 0:
            print(f"warning: no restorable '{name}' checkpoint (tried: {'; '.join(tried)})")
        return None

    def _warn_numerics(self, name: str, meta: dict) -> bool:
        """The JAX checkpointer's provenance checks of a sidecar against
        ``extra_meta``, with its words; returns True when the state LAYOUT
        (flat vs tree) differs, the one mismatch that makes loading the
        state into the trainer fail."""
        mismatch = {
            k: (meta[k], v)
            for k, v in self.extra_meta.items()
            if k in meta and meta[k] != v
        }
        missing = [k for k in self.extra_meta if k not in meta]
        layout_mismatch = mismatch.pop("flat_params", None)
        if "flat_params" in missing:
            # Sidecars without layout provenance are tree-layout ones; only
            # a flat-layout run needs the warning.
            missing.remove("flat_params")
            if self.extra_meta.get("flat_params"):
                layout_mismatch = (False, True)
        if layout_mismatch is not None:
            ck, cur = layout_mismatch
            print(
                f"warning: '{name}' checkpoint was saved in the "
                f"{'flat [P]-vector' if ck else 'standard tree'} state "
                f"layout but this run uses the "
                f"{'flat' if cur else 'tree'} layout — restore will "
                "fail with a tree-structure mismatch; "
                f"{'pass' if ck else 'drop'} --flat_params to match"
            )
        if mismatch:
            detail = ", ".join(
                f"{k}: checkpoint={a!r} current={b!r}"
                for k, (a, b) in mismatch.items()
            )
            print(
                f"warning: restoring '{name}' checkpoint trained under "
                f"different numerics ({detail}) — pass the matching flags "
                "(e.g. --gelu) to reproduce its training-time behavior"
            )
        if missing:
            print(
                f"note: '{name}' checkpoint sidecar has no recorded "
                f"{'/'.join(missing)}; the numerics check cannot "
                "verify them — if the run predates the tanh-GELU "
                "default, pass --gelu erf to restore its "
                "training-time activation"
            )
        return layout_mismatch is not None

    def restore_latest(self, *, deadline: float | None = None):
        """``(state, epoch, best_metric)`` of ``latest`` (walking its
        chain), else of ``best``, printed as a note and recorded as a
        fallback; None when neither restores. ``deadline`` (absolute
        ``time.monotonic``) clamps each I/O attempt's retry backoff."""
        out = self._restore("latest", deadline=deadline)
        if out is not None:
            return out
        out = self._restore("best", requested="latest", requested_skipped=self._skipped,
                            deadline=deadline)
        if out is not None:
            print(
                "note: no restorable 'latest' checkpoint — resumed "
                f"from 'best' ({self.last_restore['dir']}, epoch "
                f"{self.last_restore['epoch']})"
            )
        return out

    def restore_best(self, *, deadline: float | None = None):
        """``(state, epoch, best_metric)`` of ``best`` (walking its chain),
        or None."""
        return self._restore("best", deadline=deadline)
