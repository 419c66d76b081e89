"""Bytes a prefill's casts read: the program's ``cast_bytes`` counter over
the ``prefill`` spans its tracer kept while on (the traced batches), GB."""
from chipbench.spans import cast_gb


def read(run):
    return cast_gb(run)
