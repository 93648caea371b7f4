"""Versioned on-disk checkpoint store: manifest + digests + atomic commit
(the port's copy of ``titan_tpu/olap/recovery/store.py``; the format is
the same byte for byte, so each package reads the other's checkpoints).

The durability half of the superstep checkpoint plane (Pregel's
superstep-boundary checkpointing, Malewicz et al. SIGMOD 2010 §4.2 —
the canonical BSP fault-tolerance design the reference's Fulgora
executor never rebuilt). One checkpoint is one DIRECTORY::

    <root>/<job_id>/ckpt-a0001-r00000012/
        manifest.json          # written LAST, fsynced
        <name>.npy             # one file per state array
        objects.pkl            # optional host-object payload

committed by writing everything into a ``.tmp-*`` sibling and
``os.replace``-ing it into place — a crash mid-write leaves only a tmp
directory the reader never looks at, so a torn checkpoint is detected
(missing/garbled manifest), never adopted.

The manifest records the job id, attempt, round, kind and a sha256
digest + dtype/shape per array; ``load`` re-hashes every payload and
raises ``CheckpointInvalid`` on any mismatch. ``latest`` walks the
job's checkpoints newest-attempt-first / highest-round-first and
returns the first one that VALIDATES — a corrupted newest checkpoint
falls back to the previous valid one (or None → clean restart), never
to a wrong answer.

``objects.pkl`` exists for the JAX package's host BSP computer, whose
superstep state is Python dicts; it is digest-checked like the arrays
but deserialized with pickle — checkpoint directories are
trusted local state, not a wire format.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

MANIFEST = "manifest.json"
FORMAT_VERSION = 1

#: ckpt-a<attempt>-r<round> — zero-padded so lexicographic order is
#: (attempt, round) order, but the reader parses, never trusts sorting
_CKPT_RE = re.compile(r"^ckpt-a(\d+)-r(\d+)$")


class CheckpointInvalid(RuntimeError):
    """Checkpoint failed validation (torn write, digest mismatch,
    shape/dtype drift, unreadable payload). Never resumed from."""


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@dataclass
class Checkpoint:
    """One loaded-and-verified checkpoint."""

    path: str
    job_id: str
    attempt: int
    round: int
    kind: str
    meta: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)    # name -> np.ndarray
    objects: dict = field(default_factory=dict)   # host-object payload


class _Count:
    def __init__(self, table: dict, name: str):
        self._table, self._name = table, name

    def inc(self, n: int = 1) -> None:
        self._table[self._name] = self._table.get(self._name, 0) + n


class _Samples:
    def __init__(self, table: dict, name: str):
        self._table, self._name = table, name

    def update(self, x: float) -> None:
        self._table.setdefault(self._name, []).append(x)


class Counters:
    """The port's metrics sink for the checkpoint plane: named counters
    (``counts``) and histogram samples (``samples``) in plain dicts. The
    serving layer's metric registry is not ported."""

    def __init__(self):
        self.counts: dict = {}
        self.samples: dict = {}

    def counter(self, name: str) -> _Count:
        return _Count(self.counts, name)

    def histogram(self, name: str) -> _Samples:
        return _Samples(self.samples, name)


class CheckpointStore:
    """See module doc. ``metrics``: optional ``Counters`` (or any object
    with ``counter(name).inc(n)`` and ``histogram(name).update(x)``);
    when set, every committed checkpoint records
    ``serving.recovery.checkpoints`` / ``.checkpoint_bytes`` counters and
    a ``serving.recovery.checkpoint_ms`` histogram sample, and every
    checkpoint rejected during ``latest()`` bumps
    ``serving.recovery.invalid_checkpoints``."""

    def __init__(self, root: str, metrics=None,
                 prefix: str = "serving.recovery"):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._metrics = metrics
        self._prefix = prefix

    # -- paths ---------------------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.root, str(job_id))

    def checkpoints(self, job_id: str) -> list[str]:
        """Committed checkpoint paths, (attempt, round) ascending.
        Tmp leftovers and foreign entries are ignored."""
        jd = self.job_dir(job_id)
        if not os.path.isdir(jd):
            return []
        found = []
        for name in os.listdir(jd):
            m = _CKPT_RE.match(name)
            if m is not None:
                found.append((int(m.group(1)), int(m.group(2)),
                              os.path.join(jd, name)))
        found.sort()
        return [p for _a, _r, p in found]

    # -- write ---------------------------------------------------------------

    def save(self, job_id: str, *, attempt: int, round_: int, kind: str,
             arrays: Optional[dict] = None, meta: Optional[dict] = None,
             objects: Optional[dict] = None) -> str:
        """Commit one checkpoint atomically; returns its final path.
        Re-saving the same (attempt, round) replaces the old directory
        (same rename-commit, so the swap is still atomic)."""
        t0 = time.time()
        name = f"ckpt-a{attempt:04d}-r{round_:08d}"
        jd = self.job_dir(job_id)
        os.makedirs(jd, exist_ok=True)
        tmp = os.path.join(jd, f".tmp-{name}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        entries: dict = {}
        nbytes = 0
        for nm, arr in (arrays or {}).items():
            a = np.ascontiguousarray(np.asarray(arr))
            np.save(os.path.join(tmp, nm + ".npy"), a)
            entries[nm] = {"kind": "array", "digest": _digest(a.tobytes()),
                           "dtype": str(a.dtype), "shape": list(a.shape)}
            nbytes += a.nbytes
        if objects:
            blob = pickle.dumps(objects, protocol=pickle.HIGHEST_PROTOCOL)
            with open(os.path.join(tmp, "objects.pkl"), "wb") as f:
                f.write(blob)
            entries["objects"] = {"kind": "pickle",
                                  "digest": _digest(blob),
                                  "bytes": len(blob)}
            nbytes += len(blob)
        manifest = {"version": FORMAT_VERSION, "job": str(job_id),
                    "attempt": int(attempt), "round": int(round_),
                    "kind": str(kind), "meta": meta or {},
                    "entries": entries}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(jd, name)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self._metrics is not None:
            self._metrics.counter(f"{self._prefix}.checkpoints").inc()
            self._metrics.counter(
                f"{self._prefix}.checkpoint_bytes").inc(nbytes)
            self._metrics.histogram(
                f"{self._prefix}.checkpoint_ms").update(
                (time.time() - t0) * 1e3)
        return final

    # -- read ----------------------------------------------------------------

    def load(self, path: str) -> Checkpoint:
        """Read + VERIFY one checkpoint; raises ``CheckpointInvalid`` on
        any torn/corrupt/mismatched payload."""
        mpath = os.path.join(path, MANIFEST)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointInvalid(
                f"unreadable manifest at {path}: {e}") from e
        if manifest.get("version") != FORMAT_VERSION:
            raise CheckpointInvalid(
                f"unknown checkpoint format version "
                f"{manifest.get('version')!r} at {path}")
        arrays: dict = {}
        objects: dict = {}
        for nm, ent in manifest.get("entries", {}).items():
            if ent.get("kind") == "pickle":
                try:
                    with open(os.path.join(path, "objects.pkl"), "rb") as f:
                        blob = f.read()
                except OSError as e:
                    raise CheckpointInvalid(
                        f"missing objects payload at {path}: {e}") from e
                if _digest(blob) != ent["digest"]:
                    raise CheckpointInvalid(
                        f"objects digest mismatch at {path}")
                objects = pickle.loads(blob)
                continue
            try:
                a = np.load(os.path.join(path, nm + ".npy"),
                            allow_pickle=False)
            except (OSError, ValueError) as e:
                raise CheckpointInvalid(
                    f"unreadable array {nm!r} at {path}: {e}") from e
            if str(a.dtype) != ent["dtype"] \
                    or list(a.shape) != list(ent["shape"]):
                raise CheckpointInvalid(
                    f"array {nm!r} shape/dtype drift at {path}")
            if _digest(np.ascontiguousarray(a).tobytes()) != ent["digest"]:
                raise CheckpointInvalid(
                    f"array {nm!r} digest mismatch at {path}")
            arrays[nm] = a
        return Checkpoint(path=path, job_id=manifest["job"],
                          attempt=int(manifest["attempt"]),
                          round=int(manifest["round"]),
                          kind=manifest["kind"],
                          meta=manifest.get("meta", {}),
                          arrays=arrays, objects=objects)

    def validate(self, path: str) -> bool:
        try:
            self.load(path)
            return True
        except CheckpointInvalid:
            return False

    def latest(self, job_id: str) -> Optional[Checkpoint]:
        """Newest VALID checkpoint for the job (attempt desc, round
        desc), skipping — and counting — any that fail validation.
        None means no usable checkpoint: resume falls back to a clean
        restart."""
        for path in reversed(self.checkpoints(job_id)):
            try:
                return self.load(path)
            except CheckpointInvalid:
                if self._metrics is not None:
                    self._metrics.counter(
                        f"{self._prefix}.invalid_checkpoints").inc()
        return None
