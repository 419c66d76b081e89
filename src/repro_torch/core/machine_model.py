"""MachineModel — the paper's Table 1, as a data structure the framework uses.

Holds documented peaks (the paper compares measured vs documented throughout)
and measured sweep results; feeds the kernel autotuner.  The H100 entry
comes from NVIDIA's data sheet; the host and device entries are whatever
this machine reports (the benchmark proves itself on the machine it runs on,
exactly like the paper's three Arm systems).

Counterpart of ``repro.core.machine_model``, with two differences: the
registry holds ``nvidia-h100-sxm`` where the reference holds ``tpu-v5e``,
and ``detect_device`` reads a CUDA device's topology the way
``detect_host`` reads the host's sysfs.  The outermost level keeps the name
``"DRAM"`` everywhere (schema parity with the reference); on a GPU it is
the card's HBM.

Conventions:

* ``peak_flops=None`` / ``read_bw=None`` mean *undocumented* (the paper's
  Table 1 leaves several cells blank); ``0.0`` is reserved for a measured
  zero, which never occurs for a documented peak.
* Documented specs live in a name-keyed registry (``register_spec`` /
  ``get_spec``) so measurement-derived models (``repro_torch.characterize``)
  can register alongside the static tables and be looked up by the same
  name.
* ``MachineModel`` JSON carries ``model_schema_version``; v1 files (written
  before versioning) load unchanged.  ``hardware["levels"]`` is canonicalized
  to tuples-of-tuples on construction, so ``to_json``/``from_json`` round-trip
  to an *equal* object.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Optional

MODEL_SCHEMA_VERSION = 2    # 1 = unversioned seed files (list levels, no key)


@dataclass(frozen=True)
class MemLevel:
    name: str
    size_bytes: Optional[int]      # None = unbounded (DRAM/HBM)
    read_bw: Optional[float]       # documented B/s (None if undocumented)


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: Optional[float]    # documented peak FLOP/s; None = undocumented
    levels: tuple[MemLevel, ...]
    link_bw: Optional[float] = None  # interconnect B/s per link
    frequency_hz: Optional[float] = None
    notes: str = ""


#: one H100 SXM5 80 GB, NVIDIA's data sheet (dense rates).  The L1 level is
#: the aggregate of the SMs' L1/shared-memory blocks (256 KiB each, of which
#: the L1 is what shared memory leaves); the data sheet documents no L1 or
#: L2 bandwidth.
H100_SXM = HardwareSpec(
    name="nvidia-h100-sxm", peak_flops=989e12,
    levels=(MemLevel("L1", 132 * 256 * 2**10, None),
            MemLevel("L2", 50 * 2**20, None),
            MemLevel("DRAM", 80 * 2**30, 3.35e12)),
    notes="NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense, 80 GB HBM3 "
          "at 3.35 TB/s, 50 MB L2, 256 KiB L1/shared memory per SM, 132 SMs "
          "(L1 = the 132 SMs' aggregate); rates at the 700 W power limit")

# The three paper systems, for the Table-1 comparison benchmark.
A64FX = HardwareSpec(
    name="fujitsu-a64fx", peak_flops=3.072e12,
    levels=(MemLevel("L1d", 64 * 2**10, 230.4e9),
            MemLevel("L2", 8 * 2**20, 115.2e9),
            MemLevel("HBM2", 32 * 2**30, 921.6e9 / 48)),
    frequency_hz=1.8e9, notes="paper Table 1 (per-core cache BW, per-socket DRAM)")
ALTRA = HardwareSpec(
    name="ampere-altra-q80-30", peak_flops=None,   # Table 1 leaves it blank
    levels=(MemLevel("L1d", 64 * 2**10, 96e9),
            MemLevel("L2", 1 * 2**20, None),
            MemLevel("L3", 32 * 2**20, None),
            MemLevel("DRAM", 512 * 2**30, 204.8e9 / 80)),
    frequency_hz=3e9, notes="paper Table 1")
THUNDERX2 = HardwareSpec(
    name="marvell-thunderx2", peak_flops=None,     # Table 1 leaves it blank
    levels=(MemLevel("L1d", 32 * 2**10, 64e9),
            MemLevel("L2", 256 * 2**10, None),
            MemLevel("L3", 28 * 2**20, None),
            MemLevel("DRAM", 128 * 2**30, 170.5e9 / 28)),
    frequency_hz=2e9, notes="paper Table 1")


# --------------------------------------------------------------------------
# spec registry — documented tables and measurement-derived models share one
# namespace, so consumers ask for a machine by name and get whichever exists
# --------------------------------------------------------------------------

_SPECS: dict[str, HardwareSpec] = {}


def register_spec(spec: HardwareSpec, overwrite: bool = False) -> HardwareSpec:
    if spec.name in _SPECS and not overwrite:
        raise ValueError(f"spec {spec.name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _SPECS[spec.name] = spec
    return spec


def get_spec(name: str) -> HardwareSpec:
    if name == "host":          # always-fresh sysfs probe, never cached
        return detect_host()
    try:
        return _SPECS[name]
    except KeyError:
        raise KeyError(f"unknown machine spec {name!r}; "
                       f"registered: {sorted(_SPECS)} + 'host'") from None


def available_specs() -> list[str]:
    return sorted(_SPECS)


for _spec in (H100_SXM, A64FX, ALTRA, THUNDERX2):
    register_spec(_spec)


# --------------------------------------------------------------------------
# host topology from sysfs — a PRIOR, not ground truth: repro_torch's
# characterize cross-checks these sizes against measured boundaries (paper:
# documentation and measurement disagree often enough to be worth a column)
# --------------------------------------------------------------------------

_SIZE_RE = re.compile(r"^\s*(\d+)\s*([a-z]?)(?:i?b)?\s*$", re.IGNORECASE)
_SIZE_MULT = {"": 1, "k": 2**10, "m": 2**20, "g": 2**30}


def parse_cache_size(text: str) -> int:
    """'64K' / '64KiB' / '1024 kB' / '8m' / '65536' -> bytes.

    sysfs nominally emits '<n>K' but kernels and vendor drivers have shipped
    lowercase and 'KiB'-suffixed variants; all of them parse here, anything
    else raises ValueError.
    """
    m = _SIZE_RE.match(text)
    if not m:
        raise ValueError(f"unparseable cache size {text!r}")
    mult = _SIZE_MULT.get(m.group(2).lower())
    if mult is None:
        raise ValueError(f"unknown size suffix in {text!r}")
    return int(m.group(1)) * mult


def detect_host(base: str | Path = "/sys/devices/system/cpu/cpu0/cache"
                ) -> HardwareSpec:
    """Best-effort host cache topology from sysfs (sizes only; BW unmeasured
    until the sweep runs — the paper's 'documentation unavailable' case).

    Hardened: size suffixes parse case-insensitively incl. 'KiB' forms,
    duplicate index entries for the same (level, size) collapse to one
    MemLevel (some kernels expose unified caches under several indices), and
    a missing ``/sys`` tree (macOS, stripped containers) degrades to a
    DRAM-only spec instead of raising.  The result is a *prior*: the
    characterization detects the real boundaries from measurement and
    reports where the two disagree.
    """
    levels: list[MemLevel] = []
    seen: set[tuple[str, int]] = set()
    base = Path(base)
    sysfs_found = base.exists()
    if sysfs_found:
        for idx in sorted(base.glob("index*")):
            try:
                lvl = (idx / "level").read_text().strip()
                typ = (idx / "type").read_text().strip().lower()
                nb = parse_cache_size((idx / "size").read_text().strip())
            except (OSError, ValueError):
                continue
            if typ == "instruction":
                continue
            key = (f"L{lvl}", nb)
            if key in seen:     # duplicate index entry for the same cache
                continue
            seen.add(key)
            levels.append(MemLevel(f"L{lvl}", nb, None))
    levels.sort(key=lambda l: (l.size_bytes, l.name))
    levels.append(MemLevel("DRAM", None, None))
    return HardwareSpec(
        name="host-cpu", peak_flops=None, levels=tuple(levels),
        notes="sizes from sysfs (prior only); bandwidths measured by sweep"
              if sysfs_found else
              "sysfs unavailable; topology must come from measurement")


def detect_device(device=None) -> HardwareSpec:
    """The card's counterpart of ``detect_host``: a prior from
    ``torch.cuda.get_device_properties`` — the L2's size, the device
    memory's size (the outermost level, named ``"DRAM"``: HBM on the card)
    and the SM count (in ``notes``).  The driver reports no L1 size and no
    bandwidth, so the L1 level and every ``read_bw`` are left to the
    measurement.  ``device`` None = ``cuda``; raises without a CUDA
    device."""
    import torch

    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"detect_device reads a CUDA device, not {dev}; "
                         f"use detect_host() for the host")
    props = torch.cuda.get_device_properties(dev)
    return HardwareSpec(
        # 'NVIDIA H100 80GB HBM3' -> 'nvidia-h100-80gb-hbm3'
        name=re.sub(r"[^a-z0-9]+", "-", props.name.lower()).strip("-"),
        peak_flops=None,
        levels=(MemLevel("L2", int(props.L2_cache_size), None),
                MemLevel("DRAM", int(props.total_memory), None)),
        notes=f"{props.name}: {props.multi_processor_count} SMs, "
              f"L2 {props.L2_cache_size} B, {props.total_memory} B device "
              f"memory, from torch.cuda.get_device_properties (prior only; "
              f"no L1 size or bandwidth is reported)")


def _canon_levels(levels) -> tuple[tuple, ...]:
    """[(name, size, bw), ...] in any list/tuple nesting -> tuple of tuples."""
    return tuple(tuple(l) for l in levels)


@dataclass
class MachineModel:
    """Measured model of one machine: per-level bandwidth per mix + ridge."""
    hardware: dict
    level_bw: dict = field(default_factory=dict)   # level -> {mix: GB/s}
    ridge_flops_per_byte: Optional[float] = None
    mix_penalty: dict = field(default_factory=dict)  # mix -> relative to best
    model_schema_version: int = MODEL_SCHEMA_VERSION

    def __post_init__(self):
        # canonical levels: a freshly built model and a JSON-reloaded one
        # compare equal (json turns tuples into lists; we turn them back)
        if isinstance(self.hardware, dict) and "levels" in self.hardware:
            self.hardware = {**self.hardware,
                             "levels": _canon_levels(self.hardware["levels"])}

    def to_json(self, path):
        Path(path).write_text(json.dumps(asdict(self), indent=2, default=str))

    @staticmethod
    def from_dict(d: dict) -> "MachineModel":
        d = dict(d)
        ver = d.pop("model_schema_version", 1)   # v1: files without the key
        if ver > MODEL_SCHEMA_VERSION:
            raise ValueError(f"machine-model schema {ver} newer than "
                             f"supported {MODEL_SCHEMA_VERSION}")
        return MachineModel(**d, model_schema_version=ver)

    @staticmethod
    def from_json(path) -> "MachineModel":
        return MachineModel.from_dict(json.loads(Path(path).read_text()))
