"""Typed failures of the port (the subset of the reference package's
`core/resilience.py` that the ported modules raise)."""
from __future__ import annotations


class UnknownRequestError(KeyError):
    """`result()`/`profile_result()` on an unknown or already-delivered
    rid (results are read-once)."""

    def __init__(self, rid):
        super().__init__(rid)
        self.rid = rid

    def __str__(self) -> str:
        return (f"request id {self.rid!r} is unknown or already "
                "delivered (results are read-once)")


class IndexIntegrityError(RuntimeError):
    """A CRC32 self-check of index/arena blobs failed — the bytes do not
    match the checksums recorded at baseline time. The store must not
    serve: corruption surfaces as this typed error, never as a wrong
    distance."""
