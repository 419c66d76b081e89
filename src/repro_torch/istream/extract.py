"""SASS extraction: the instruction stream of the hand-written CUDA kernels.

Counterpart of ``repro.istream.extract``, which parses the optimized HLO that
XLA compiles a case to.  The port's kernels are hand-written CUDA C++, so the
code that runs is their SASS: ``cuobjdump -sass`` of the shared libraries
``repro_torch.kernels.build`` writes under ``build/<package>/``.  This module
is the pure-text half (no device, no toolkit once the text is in hand):

    sass_of / parse_sass   the text -> kernel name -> its instructions
    sass_ops               (address, opcode, instruction) triples
    loads_in_loops         global loads that lie inside a loop
    kernel_loops           each loop (a backward BRA and its target, nested
                           loops included) with its per-trip counts and its
                           counter's stride
    critical_path          the longest chain of dependent loads in a loop
                           body (the chase's chain shows here)

Instruction classes (``classify``), per thread that executes one:

* global loads by byte width: ``LDG`` (``.E`` 4 bytes, ``.64`` 8, ``.128``
  16, ``.U16`` 2, ``.U8`` 1) and ``LDGSTS`` (cp.async, global -> shared);
* global stores: ``STG``, the same widths;
* shared-memory traffic, kept apart: ``LDS``, ``LDSM`` (``.M88.4``: 16 bytes
  a thread), ``STS``;
* arithmetic in elements: ``FADD``, ``FMUL``, ``FFMA`` 1 each, ``HFMA2``
  2 (but ``HFMA2.MMA Rd, -RZ, RZ, a, b``, the
  compiler's idiom for a 32-bit constant, is a move), ``HMMA`` by its shape
  (``.16816``: 16 x 8 x 16 multiply-adds a warp instruction, 64 a thread);
* every other instruction: issue work only.

The static counts here are what the code holds, not what it retires: a loop
body is counted once a trip, its trips are run-time values.
``repro_torch.istream.emulate`` executes the same instructions for a
launch's geometry and arguments, which gives the dynamic counts the audit and
the profiles use.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

#: the opcodes of a global load: a load into registers, and cp.async's
#: global -> shared copy (not LDGDEPBAR, which only waits for copies)
GLOBAL_LOAD_OPS = ("LDG", "LDGSTS")
GLOBAL_STORE_OPS = ("STG",)
SHARED_OPS = ("LDS", "LDSM", "STS")
#: arithmetic in elements a thread-instruction (HMMA: by its shape)
ARITH_WEIGHT = {"FADD": 1, "FMUL": 1, "FFMA": 1, "HFMA2": 2}
_HMMA_SHAPES = {"16816": 16 * 8 * 16, "1688": 16 * 8 * 8, "884": 8 * 8 * 4}

_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_INSTR = re.compile(r"(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)"
                    r"((?:\.[A-Za-z0-9_]+)*)\s*(.*)$")


def find_cuobjdump() -> str:
    """The toolkit's ``cuobjdump`` (beside ``nvcc``); raises naming it when
    the toolkit is not installed."""
    import os
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "cuobjdump not found (looked on PATH and under $CUDA_HOME / "
        "/usr/local/cuda): the live SASS audit needs the CUDA toolkit; "
        "pass --goldens DIR to audit committed SASS instead")


def dump_sass(path) -> str:
    """``cuobjdump -sass`` of a built library (the whole text)."""
    return subprocess.run([find_cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def parse_sass(text: str) -> dict[str, list[str]]:
    """Kernel (mangled) name -> its SASS instruction lines, in address
    order; the encoding comment lines of ``cuobjdump`` are dropped."""
    kernels: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name is not None and _LINE.match(line):
            kernels[name].append(line.rstrip())
    return kernels


def sass_of(path: Path) -> dict[str, list[str]]:
    """Kernel name -> its SASS lines (``cuobjdump -sass`` of a library)."""
    return parse_sass(dump_sass(path))


def sass_ops(lines: list[str]) -> list[tuple[int, str, str]]:
    """(address, opcode, instruction) of each SASS instruction: the opcode
    is the instruction's first word after any predicate, without its
    modifiers (``@P0 LDG.E.128 R4, ...`` -> ``LDG``)."""
    ops = []
    for ln in lines:
        m = _LINE.match(ln)
        if not m:
            continue
        body = _INSTR.match(m.group(2))
        if body:
            ops.append((int(m.group(1), 16), body.group(2),
                        body.group(2) + body.group(3) + " " + body.group(4)))
    return ops


@dataclass(frozen=True)
class Instr:
    """One SASS instruction: address, guard predicate (``"!P0"``, ``""``),
    opcode, modifiers and operand strings."""
    addr: int
    guard: str
    op: str
    mods: tuple[str, ...]
    args: tuple[str, ...]

    @property
    def text(self) -> str:
        return ".".join((self.op,) + self.mods) + " " + ", ".join(self.args)


def _split_args(s: str) -> tuple[str, ...]:
    out, depth, cur = [], 0, ""
    for ch in s:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return tuple(out)


def decode(lines: list[str]) -> list[Instr]:
    """The instructions of one kernel's SASS lines."""
    out = []
    for ln in lines:
        m = _LINE.match(ln)
        if not m:
            continue
        body = _INSTR.match(m.group(2))
        if not body:
            continue
        args = body.group(4)
        if body.group(2) in ("BRA", "CALL", "BSSY", "WARPSYNC", "RET"):
            args = args.replace(" 0x", ", 0x") if "," not in args else args
        out.append(Instr(addr=int(m.group(1), 16),
                         guard=(body.group(1) or "").strip().lstrip("@"),
                         op=body.group(2),
                         mods=tuple(x for x in body.group(3).split(".") if x),
                         args=_split_args(args)))
    return out


# -- instruction classes ----------------------------------------------------

def access_bytes(ins: Instr) -> int:
    """Bytes a thread moves in one global or shared access (0 otherwise)."""
    if ins.op not in GLOBAL_LOAD_OPS + GLOBAL_STORE_OPS + SHARED_OPS:
        return 0
    mods = set(ins.mods)
    if ins.op == "LDSM":
        n = next((int(m) for m in ins.mods if m in ("1", "2", "4")), 1)
        return 4 * n
    for width, nbytes in (("128", 16), ("64", 8), ("U16", 2), ("S16", 2),
                          ("U8", 1), ("S8", 1)):
        if width in mods:
            return nbytes
    return 4


def is_const_move(ins: Instr) -> bool:
    """``HFMA2.MMA Rd, -RZ, RZ, hi, lo``: the compiler's way to put a 32-bit
    constant in a register (0 x 0 + constant), not arithmetic."""
    return (ins.op == "HFMA2" and len(ins.args) >= 3
            and ins.args[1] in ("-RZ", "RZ") and ins.args[2] == "RZ")


def arith_weight(ins: Instr) -> int:
    """Arithmetic elements one thread-instruction computes."""
    if ins.op == "HMMA":
        shape = next((_HMMA_SHAPES[m] for m in ins.mods
                      if m in _HMMA_SHAPES), 0)
        return shape // 32
    if is_const_move(ins):
        return 0
    return ARITH_WEIGHT.get(ins.op, 0)


def classify(ins: Instr) -> str:
    """``load``, ``store``, ``shared``, ``arith`` or ``other``."""
    if ins.op in GLOBAL_LOAD_OPS:
        return "load"
    if ins.op in GLOBAL_STORE_OPS:
        return "store"
    if ins.op in SHARED_OPS:
        return "shared"
    if arith_weight(ins):
        return "arith"
    return "other"


# -- loops ------------------------------------------------------------------

def _branch_target(ins: Instr) -> int | None:
    for a in reversed(ins.args):
        if a.startswith("0x"):
            return int(a, 16)
    return None


def loads_in_loops(ops: list[tuple[int, str, str]]) -> int:
    """Global loads of a kernel's SASS that lie inside a loop: between a
    backward branch and its target."""
    loads, loops = [], []
    for addr, op, ins in ops:
        if op in GLOBAL_LOAD_OPS:
            loads.append(addr)
        b = re.findall(r"0x([0-9a-f]+)", ins) if op == "BRA" else None
        if b and int(b[-1], 16) <= addr:
            loops.append((int(b[-1], 16), addr))
    return sum(any(lo <= a <= hi for lo, hi in loops) for a in loads)


@dataclass
class Loop:
    """One loop of a kernel: the backward BRA at ``end`` to ``start``, its
    parent (the innermost loop that holds it, or None), the counts of one
    trip of its own body (nested loops excluded), the stride of its counter
    (the source iterations one trip holds, where the SASS shows it) and the
    dependent-load chain of one trip."""
    start: int
    end: int
    parent: int | None = None
    per_trip: dict = field(default_factory=dict)
    stride: int | None = None
    load_chain: int = 0


def _regs(arg: str) -> list[str]:
    """The registers an operand reads (a pair ``R4.64`` reads R4 and R5)."""
    out = []
    for m in re.finditer(r"\b(U?R)(\d+)(\.64)?", arg):
        out.append(f"{m.group(1)}{m.group(2)}")
        if m.group(3):
            out.append(f"{m.group(1)}{int(m.group(2)) + 1}")
    return out


def _dests(ins: Instr) -> list[str]:
    """Registers an instruction writes (its first operand, when a register;
    the width of a wide load or pair result included)."""
    if not ins.args or ins.op in ("STG", "STS", "BRA", "BSSY", "BSYNC",
                                  "EXIT", "CALL", "RET", "BAR", "LDGSTS",
                                  "WARPSYNC", "NOP"):
        return []
    m = re.fullmatch(r"(U?R)(\d+)", ins.args[0].split(".")[0])
    if not m:
        return []
    width = 1
    if ins.op in ("LDG", "LDS", "LDC", "ULDC"):
        width = max(access_bytes(ins) // 4, 1) if ins.op in ("LDG", "LDS") \
            else (2 if "64" in ins.mods else 1)
    elif ins.op == "LDSM":
        width = access_bytes(ins) // 4
    elif ins.op == "HMMA" or "WIDE" in ins.mods or ins.op == "CS2R":
        width = 4 if ins.op == "HMMA" else 2
    return [f"{m.group(1)}{int(m.group(2)) + i}" for i in range(width)]


def critical_path(body: list[Instr]) -> int:
    """The longest chain of dependent loads in a straight run of
    instructions: a load (global or shared) whose address register comes,
    through any instructions, from an earlier load is one level deeper."""
    depth: dict[str, int] = {}
    best = 0
    for ins in body:
        srcs = [r for a in ins.args[1:] if not a.startswith("0x")
                for r in _regs(a)]
        if ins.op in ("STG", "STS", "LDGSTS"):
            srcs = [r for a in ins.args for r in _regs(a)]
        d = max((depth.get(r, 0) for r in srcs), default=0)
        if ins.op in GLOBAL_LOAD_OPS + ("LDS", "LDSM"):
            d += 1
            best = max(best, d)
        for r in _dests(ins):
            depth[r] = d
    return best


def _counter_stride(body: list[Instr], end: Instr) -> int | None:
    """The stride of a loop's counter: the immediate of the add (IADD3,
    VIADD, UIADD3, IMAD.IADD) to the register that the last compare before
    the backward branch reads, where there is one."""
    cmp = next((i for i in reversed(body)
                if i.op in ("ISETP", "UISETP") and i.addr < end.addr), None)
    if cmp is None:
        return None
    regs = set(_regs(cmp.args[2]) + _regs(cmp.args[3]))
    for ins in reversed(body):
        if ins.op in ("IADD3", "VIADD", "UIADD3") and ins.args \
                and ins.args[0].split(".")[0] in regs:
            for a in ins.args[1:]:
                if re.fullmatch(r"-?0x[0-9a-f]+", a):
                    v = int(a, 16)
                    return abs(v - 2**32 if v >= 2**31 else v)
    return None


def kernel_loops(lines_or_instrs) -> list[Loop]:
    """Every loop of one kernel's SASS, outermost first, with its per-trip
    counts by class (loads / stores / shared in bytes a thread, arith in
    elements, other in instructions, instructions in all)."""
    instrs = lines_or_instrs if lines_or_instrs and isinstance(
        lines_or_instrs[0], Instr) else decode(lines_or_instrs)
    spans = []
    for ins in instrs:
        if ins.op == "BRA":
            t = _branch_target(ins)
            if t is not None and t < ins.addr:
                spans.append((t, ins.addr))
    spans.sort(key=lambda s: (s[0], -s[1]))
    loops = []
    for lo, hi in spans:
        parents = [s for s in spans if s != (lo, hi) and s[0] <= lo
                   and hi <= s[1]]
        parent = max(parents, key=lambda s: s[0])[0] if parents else None
        inner = [s for s in spans if s != (lo, hi) and lo <= s[0]
                 and s[1] <= hi]
        body = [i for i in instrs if lo <= i.addr <= hi
                and not any(a <= i.addr <= b for a, b in inner)]
        c = {"loads": 0, "stores": 0, "shared": 0, "arith": 0, "other": 0,
             "instructions": len(body)}
        for ins in body:
            kind = classify(ins)
            if kind in ("load", "store", "shared"):
                c[kind + "s" if kind != "shared" else "shared"] += \
                    access_bytes(ins)
            elif kind == "arith":
                c["arith"] += arith_weight(ins)
            else:
                c["other"] += 1
        end = next(i for i in instrs if i.addr == hi)
        loops.append(Loop(start=lo, end=hi, parent=parent, per_trip=c,
                          stride=_counter_stride(body, end),
                          load_chain=critical_path(body)))
    return loops


def prune_sass(text: str, keep) -> str:
    """The text of ``cuobjdump -sass`` cut to the kernels named in ``keep``
    and to their instruction lines (the encoding comments dropped): what
    the goldens hold.  ``parse_sass`` reads it back unchanged."""
    out = []
    for name, lines in parse_sass(text).items():
        if name not in keep:
            continue
        out.append(f"\t\tFunction : {name}")
        out.extend(re.sub(r"\s*/\* 0x[0-9a-f]+ \*/\s*$", "", ln)
                   for ln in lines)
    return "\n".join(out) + "\n"
