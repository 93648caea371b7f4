"""Exception taxonomy for titan_tpu_torch.

Mirrors the capability of the reference's two-tier backend exception model
(reference: titan-core diskstorage/TemporaryBackendException.java,
PermanentBackendException.java) plus graph-level errors: temporary errors are
retried with backoff by the backend-operation executor
(storage/tx.py:backend_op); permanent errors escalate immediately.
"""

from __future__ import annotations


class TitanError(Exception):
    """Root of all titan_tpu_torch errors."""


class ConfigurationError(TitanError):
    """Invalid or unsupported configuration (bad backend name, option
    value out of range, mutually exclusive settings)."""


# ---------------------------------------------------------------------------
# storage plane
# ---------------------------------------------------------------------------

class BackendError(TitanError):
    """Any error raised by the storage/index plane."""


class TemporaryBackendError(BackendError):
    """Transient failure (timeouts, contention); safe to retry with backoff."""


class PermanentBackendError(BackendError):
    """Non-retriable failure (corruption, misconfiguration, unsupported op)."""


class TemporaryLockingError(TemporaryBackendError):
    """Lock could not be acquired right now (held by someone else)."""


class PermanentLockingError(PermanentBackendError):
    """Lock protocol failed irrecoverably (e.g. expected-value mismatch)."""


class IDPoolExhaustedError(TemporaryBackendError):
    """An id partition/namespace ran out of allocatable blocks."""


# ---------------------------------------------------------------------------
# graph plane
# ---------------------------------------------------------------------------

class InvalidIDError(TitanError):
    """Element id does not satisfy the bit-layout contract (ids/idmanager.py)."""


class InvalidElementError(TitanError):
    """Operation on a removed or foreign element."""

    def __init__(self, msg: str, element=None):
        super().__init__(msg)
        self.element = element


class SchemaViolationError(TitanError):
    """Operation violates a schema constraint (cardinality, multiplicity, ...)."""


class SchemaNameExistsError(SchemaViolationError):
    """A schema element with this name already exists (possibly created by
    a racing transaction or peer instance)."""


class QueryError(TitanError):
    """Malformed or unsupported query."""


class TransactionClosedError(TitanError):
    """Operation on a committed/rolled-back transaction."""


def not_ported(what: str) -> NotImplementedError:
    """The error raised for the part of the JAX package that the port
    leaves out by design: the ``tpu`` computer, whose counterpart is the
    port's ``gpu`` computer."""
    return NotImplementedError(
        f"{what} is not ported: the port's counterpart of the JAX "
        "package's TPU computer is computer.backend='gpu'")


#: top-level packages the port never imports, not even by a name it is
#: given at run time (a scan-job factory, an index backend, a store path)
FOREIGN_PACKAGES = ("titan_tpu", "jax", "jaxlib")


def refuse_foreign(path: str, what: str) -> None:
    """Raise ``ValueError`` before any import when ``path`` (dotted, or
    ``module:callable``) names a module of the JAX package or of JAX: a
    job spec or a config written for the JAX package fails as a fault of
    the job, never by loading JAX into the port's process."""
    top = path.split(":", 1)[0].split(".", 1)[0]
    if top in FOREIGN_PACKAGES:
        raise ValueError(
            f"{what} {path!r} is under {top!r}, which titan_tpu_torch never "
            "imports; name its titan_tpu_torch counterpart")
