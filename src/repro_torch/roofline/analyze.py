"""Three-term roofline of one step, from the port's own counts
(counterpart of ``repro.roofline.analyze``):

  compute    = FLOPs                / peak FLOP/s            [per device]
  memory     = HBM bytes            / HBM bandwidth          [per device]
  collective = sum over collectives of ring-model time       [per device]

The constants are the H100's, never a TPU's: ``PEAK_FLOPS_BF16`` and
``HBM_BW`` from ``core.machine_model.H100_SXM`` (NVIDIA's H100 SXM5 data
sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3) and ``LINK_BW``, NVLink 4's
450 GB/s a direction (the same data sheet's 900 GB/s, both directions);
the field keeps the reference's name ``ici_bw``, and one rate serves every
mesh axis, the pod axis too, as the reference's single ICI rate does.

Where the reference reads FLOPs from XLA's ``cost_analysis`` and parses the
collectives out of compiled HLO text, the port counts: FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, and the collectives from the
log ``distributed.sharding.ShardCtx.recording`` keeps of every collective
the sharded code issues, each counted by the bytes of its result, as the
reference's parser counts them (``launch.dryrun``).  So there is no
``parse_collectives``; ``analyze`` takes a record of those counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.machine_model import H100_SXM

#: one H100 SXM5 (per card)
PEAK_FLOPS_BF16 = H100_SXM.peak_flops           # FLOP/s
HBM_BW = H100_SXM.levels[-1].read_bw            # B/s
#: NVLink 4, per direction (NVIDIA H100 SXM5 data sheet: 900 GB/s total)
LINK_BW = 450e9                                 # B/s
#: the card's memory, the spec's outermost level (80 GB)
HBM_BYTES = H100_SXM.levels[-1].size_bytes


@dataclass
class CollectiveOp:
    kind: str
    bytes: int
    group_size: int


@dataclass
class RooflineTerms:
    flops: float                   # per-device flops
    hbm_bytes: float               # per-device HBM bytes
    collectives: list[CollectiveOp] = field(default_factory=list)
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = LINK_BW

    @property
    def collective_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        """Ring model per op: all-reduce 2(n-1)/n, ag/rs (n-1)/n, a2a (n-1)/n,
        permute 1 hop.  bytes are the (per-device) result bytes."""
        t = 0.0
        for c in self.collectives:
            n = max(c.group_size, 1)
            if n == 1:
                continue
            if c.kind == "all-reduce":
                f = 2 * (n - 1) / n
            elif c.kind in ("all-gather", "reduce-scatter", "all-to-all"):
                f = (n - 1) / n
            else:  # collective-permute: single hop
                f = 1.0
            t += f * c.bytes / self.ici_bw
        return t

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "n_collectives": len(self.collectives),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def machine_constants(machine) -> dict:
    """Roofline constants from any machine-model flavor, for RooflineTerms.

    Accepts a ``characterize.FittedMachineModel`` (measured: ``peak_flops``
    / ``hbm_bw`` properties), a ``core.machine_model.HardwareSpec``
    (documented: outermost level ``read_bw`` + ``link_bw``), or a registry
    name string (``core.machine_model.get_spec``).  Constants the model
    does not know (None = undocumented/unmeasured) keep the H100 defaults —
    callers can see which were overridden in the returned dict.
    """
    if machine is None:
        return {}
    if isinstance(machine, str):
        from repro_torch.core.machine_model import get_spec
        machine = get_spec(machine)
    out = {}
    peak = getattr(machine, "peak_flops", None)
    if peak:
        out["peak_flops"] = float(peak)
    hbm = getattr(machine, "hbm_bw", None)      # FittedMachineModel (measured)
    if hbm is None:                             # HardwareSpec (documented)
        levels = getattr(machine, "levels", ())
        if levels:
            hbm = getattr(levels[-1], "read_bw", None)
    if hbm:
        out["hbm_bw"] = float(hbm)
    ici = getattr(machine, "link_bw", None)
    if ici:
        out["ici_bw"] = float(ici)
    return out


def analyze(record: dict, model_flops: float | None = None,
            machine=None) -> dict:
    """Full roofline record for one (arch x shape x mesh) cell from the
    port's counts: ``record`` holds ``flops`` (a rank's, from the FLOP
    counter), ``hbm_bytes`` (``model_bytes.analytic_bytes``),
    ``collectives`` (the ``CollectiveOp`` list of the collective log) and
    the memory fields it has (``peak_device_bytes``, ``arg_bytes``, ...),
    which pass through.  ``machine`` (optional) replaces the H100's data
    sheet constants with a machine model's — the ``FittedMachineModel``
    that ``repro_torch.characterize`` measured on the card, a documented
    ``HardwareSpec``, or a spec registry name; see ``machine_constants``."""
    colls = list(record.get("collectives", ()))
    mc = machine_constants(machine)
    terms = RooflineTerms(flops=float(record["flops"]),
                          hbm_bytes=float(record["hbm_bytes"]),
                          collectives=colls, **mc)
    out = {
        **terms.summary(),
        **{k: v for k, v in record.items()
           if k not in ("flops", "hbm_bytes", "collectives")},
        "collective_breakdown": _breakdown(colls),
    }
    if model_flops is not None:
        out["model_flops"] = model_flops
        out["useful_flop_ratio"] = (model_flops / terms.flops if terms.flops
                                    else 0.0)
    if machine is not None:
        out["machine_model"] = getattr(machine, "name", str(machine))
        out["machine_constants"] = mc
    return out


def _breakdown(colls: list[CollectiveOp]) -> dict:
    agg: dict[str, dict] = {}
    for c in colls:
        a = agg.setdefault(c.kind, {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += c.bytes
    return agg
