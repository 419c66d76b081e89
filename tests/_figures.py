"""What the figure tests of the port share (``test_torch_figures*.py``):
row names parsed from ``name,us_per_call,derived`` lines, accounting
tuples, spec comparison across the packages and a recording Runner."""
import re
from pathlib import Path

from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(backend="torch", device="cpu")
#: the patched size ladder of the small runs (<= 128 KiB)
SMALL = (32 * 2**10, 64 * 2**10)
ROW = re.compile(r"^(?:\[p\d+\] )?([a-z0-9_]+/[^,]+),(-?[0-9.]+),(.*)$")
ACCOUNTING = ("mix", "nbytes", "nbytes_requested", "dtype", "passes",
              "bytes_per_call", "flops_per_call", "streams", "block_rows",
              "unroll", "interleave", "devices", "load")


def row_names(text: str) -> list[str]:
    """The emitted row names (``name,us_per_call,derived`` lines)."""
    return [m.group(1) for m in map(ROW.match, text.splitlines()) if m]


def map_rows(names: list[str]) -> list[str]:
    """Reference row names with the backend names mapped to the port's."""
    table = convert.BACKEND_FROM_REFERENCE
    return ["/".join(table.get(part, part) for part in name.split("/"))
            for name in names]


def accounting(points) -> list[tuple]:
    return [tuple(getattr(p, f) for f in ACCOUNTING) for p in points]


def same_specs(ref_specs, port_specs) -> None:
    want = [convert.spec_from_reference(s.to_dict()) for s in ref_specs]
    assert [s.to_dict() for s in port_specs] == want


class Stop(Exception):
    """Ends a script at its first measurement, once its specs are seen."""


def recording(base, log: list, stop: Exception):
    """A Runner subclass that records every spec it is given and raises
    ``stop`` instead of running it."""
    class Recording(base):
        def run(self, spec, *a, **kw):
            log.append(spec)
            raise stop

        def run_many(self, specs, *a, **kw):
            log.extend(specs)
            raise stop
    return Recording
