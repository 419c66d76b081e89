"""Execute a kernel's SASS for one launch and count what it does.

The static counts of ``extract`` say what a loop body holds; how often each
body runs depends on the launch: the grid, the block, the kernel's arguments
(``passes``, the tile geometry) and each thread's indices pick the path
through the code (the persistent kernels of ``acc.cu`` hold three loop nests
of which one runs) and the trips of every loop (nvcc unrolls a loop of
unknown count into a pipelined main loop and remainder loops).  This module
runs the instructions themselves, for every thread of the launch, with the
arguments the wrapper passes, and counts each executed instruction by its
class (``extract.classify``).

What it models: the integer, predicate, uniform-datapath and control
instructions exactly (32-bit registers, carries, 64-bit compares, the
float reciprocal steps of integer division, calls and returns), and the
kernel parameters in constant bank 0 from offset 0x210 (``c[0x0][0xc]`` is
gridDim.x).  What it does not: memory.  A load writes zeros to its
registers and is counted; a store is counted and writes nothing; shuffles,
tensor-core products and data conversions write zeros.  So a kernel whose
control flow depended on loaded data could be mis-run; none of the membench
kernels' does (the chase's loaded index is an address, never a branch
condition), and an opcode the emulator does not know raises, naming it.

Threads run in lockstep by the smallest program counter among them (the
lanes that wait at a later address are masked off), so divergent loops and
predicated tails count exactly.  A thread's instructions count once each
(``thread_instructions``); the warps that issue an instruction count once
each (``warp_instructions``: the issue work).
"""
from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

import numpy as np

from repro_torch.istream.extract import (Instr, access_bytes, arith_weight,
                                         classify, decode, is_const_move)

M32 = np.uint64(0xFFFFFFFF)
_DONE = np.int64(1 << 40)           # the program counter of an exited thread
PARAM_BASE = 0x210


class UnknownSassError(RuntimeError):
    """An instruction the emulator does not model (the counts would be
    wrong, so nothing is counted)."""


@dataclass
class LaunchCounts:
    """What one launch executed, summed over its threads: bytes moved by
    global loads / stores and shared-memory accesses, arithmetic elements,
    thread- and warp-instructions, instructions by opcode, trips taken by
    each loop (by its start address) and the longest dependent-load chain
    any thread ran."""
    load_bytes: int = 0
    store_bytes: int = 0
    shared_bytes: int = 0
    arith: int = 0
    other: int = 0
    thread_instructions: int = 0
    warp_instructions: int = 0
    opcodes: dict = field(default_factory=dict)
    loop_trips: dict = field(default_factory=dict)
    load_chain: int = 0

    def add(self, other: "LaunchCounts", times: int = 1) -> None:
        for k in ("load_bytes", "store_bytes", "shared_bytes", "arith",
                  "other", "thread_instructions", "warp_instructions"):
            setattr(self, k, getattr(self, k) + times * getattr(other, k))
        for k, v in other.opcodes.items():
            self.opcodes[k] = self.opcodes.get(k, 0) + times * v
        for k, v in other.loop_trips.items():
            self.loop_trips[k] = self.loop_trips.get(k, 0) + times * v
        self.load_chain = max(self.load_chain, other.load_chain)


def pack_params(params) -> bytes:
    """Kernel arguments as the constant bank holds them: ``params`` is a
    sequence of (kind, value) with kind ``ptr`` (8 bytes), ``i32``,
    ``i64`` or ``bytes`` (a by-value struct), each at its natural
    alignment."""
    out = bytearray()
    for kind, value in params:
        size = {"ptr": 8, "i64": 8, "i32": 4}.get(kind, 8)
        while len(out) % size:
            out.append(0)
        if kind == "bytes":
            out += bytes(value)
        elif kind == "i32":
            out += struct.pack("<i", int(value))
        else:
            out += struct.pack("<Q", int(value) & (2**64 - 1))
    while len(out) % 8:
        out.append(0)
    return bytes(out)


_IMM = re.compile(r"-?0x[0-9a-f]+\Z")
_PRED = re.compile(r"U?P[T0-9]\Z")
_PREDX = re.compile(r"!?U?P[T0-9]\Z")
_FLOAT = re.compile(r"-?(\d+(\.\d*)?(e[-+]?\d+)?|INF|QNAN|\+INF)\Z")
_CONST = re.compile(r"c\[0x([0-9a-f]+)\]"
                    r"\[(?:(U?R\w+)\s*\+?)?(-?0x[0-9a-f]+)?\]")


def _split(args):
    """(destination, carry-out predicates, operands, carry-in predicates)
    of an integer instruction's operand list."""
    i = 1
    outs = []
    while i < len(args) and _PRED.match(args[i]):
        outs.append(args[i])
        i += 1
    rest = list(args[i:])
    cins = []
    while rest and _PREDX.match(rest[-1]):
        cins.insert(0, rest.pop())
    return args[0], outs, rest, cins


def _f32_bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)


def _bits_f32(v: np.ndarray) -> np.ndarray:
    return (np.asarray(v) & M32).astype(np.uint32).view(np.float32)


def _u(x) -> np.ndarray:
    """An operand's value as uint64 (registers hold 32-bit values)."""
    return np.asarray(x, dtype=np.uint64)


def _signed(v) -> np.ndarray:
    """32-bit values held in uint64, as signed int64."""
    v = _u(v) & M32
    return v.astype(np.int64) - (v >> np.uint64(31)).astype(np.int64) * 2**32


def _neg(v) -> np.ndarray:
    """Two's complement negation of 32-bit values."""
    return (~_u(v) + np.uint64(1)) & M32


class _State:
    def __init__(self, n: int, block: int, grid: tuple, params: bytes):
        self.n = n
        self.r: dict[str, np.ndarray] = {}
        self.p: dict[str, np.ndarray] = {}
        self.dep: dict[str, np.ndarray] = {}
        zero = np.zeros(n, dtype=np.uint64)
        self.zero = zero
        lane = np.arange(n, dtype=np.int64)
        pad = -(-block // 32) * 32
        cta = lane // pad
        self.special = {
            "SR_TID.X": (lane % pad).astype(np.uint64),
            "SR_TID.Y": zero, "SR_TID.Z": zero,
            "SR_CTAID.X": (cta % grid[0]).astype(np.uint64),
            "SR_CTAID.Y": (cta // grid[0]).astype(np.uint64),
            "SR_CTAID.Z": zero,
            "SR_LANEID": (lane % 32).astype(np.uint64),
        }
        bank = bytearray(PARAM_BASE + len(params) + 64)
        for off, v in ((0x0, block), (0x4, 1), (0x8, 1), (0xc, grid[0]),
                       (0x10, grid[1]), (0x14, 1)):
            bank[off:off + 4] = struct.pack("<I", v)
        bank[0x28:0x2c] = struct.pack("<I", 0xfffc00)    # stack pointer
        bank[PARAM_BASE:PARAM_BASE + len(params)] = params
        self.bank = np.frombuffer(bytes(bank), dtype=np.uint32).astype(
            np.uint64)
        self.alive = (lane % pad) < block


class Emulator:
    """Runs one kernel's decoded SASS (``extract.decode``)."""

    def __init__(self, instrs: list[Instr], name: str = "kernel"):
        self.name = name
        self.instrs = instrs
        self.index = {ins.addr: i for i, ins in enumerate(instrs)}
        self.loop_starts = {}
        for ins in instrs:
            if ins.op == "BRA":
                t = next((int(a, 16) for a in reversed(ins.args)
                          if a.startswith("0x")), None)
                if t is not None and t < ins.addr:
                    self.loop_starts[ins.addr] = t
        self._compiled = [self._compile(ins) for ins in instrs]
        self._guards = [self._pred(ins.guard) if ins.guard else None
                        for ins in instrs]
        self._mem = [self._mem_info(ins) if k == "mem" else None
                     for ins, (k, _) in zip(instrs, self._compiled)]

    # -- operands --------------------------------------------------------
    def _reader(self, arg: str):
        """A function state -> uint64 array (or int) for one operand."""
        neg = inv = absolute = False
        a = arg.replace(".reuse", "")
        if a.startswith("-") and not _IMM.match(a) and not _FLOAT.match(a):
            neg, a = True, a[1:]
        if a.startswith("~"):
            inv, a = True, a[1:]
        if a.startswith("|") and a.endswith("|"):
            absolute, a = True, a[1:-1]
        if _IMM.match(a):
            v = int(a, 16) & 0xFFFFFFFF
            base = lambda st, v=v: np.uint64(v)
        elif a in ("RZ", "URZ", "SRZ"):
            base = lambda st: np.uint64(0)
        elif re.fullmatch(r"U?R\d+(\.[A-Z0-9_]+)?", a):
            name = a.split(".")[0]
            base = lambda st, name=name: st.r.get(name, st.zero)
        elif a.startswith("SR_"):
            base = lambda st, a=a: st.special.get(a, st.zero)
        elif a.startswith("c["):
            m = _CONST.match(a)
            off = int(m.group(3), 16) if m.group(3) else 0
            reg = m.group(2)
            if reg:
                base = lambda st, reg=reg, off=off: st.bank[
                    ((st.r.get(reg, st.zero).astype(np.int64) + off) // 4)
                    .clip(0, len(st.bank) - 1)]
            else:
                base = lambda st, off=off: st.bank[off // 4]
        elif _FLOAT.match(a) or a in ("+INF", "-INF", "QNAN"):
            f = float(a.replace("QNAN", "nan").replace("INF", "inf"))
            v = int(_f32_bits(f))
            base = lambda st, v=v: np.uint64(v)
            neg = False
        else:
            raise UnknownSassError(f"{self.name}: operand {arg!r} not modeled")
        if not (neg or inv or absolute):
            return base
        return lambda st: self._mod(base(st), neg, inv, absolute)

    @staticmethod
    def _mod(v, neg, inv, absolute):
        v = _u(v)
        if absolute:
            v = np.where(v & np.uint64(0x80000000), _neg(v), v)
        if inv:
            v = ~v & M32
        if neg:
            v = _neg(v)
        return v

    def _pred(self, arg: str):
        a = arg.strip()
        neg = a.startswith("!")
        a = a.lstrip("!")
        if a in ("PT", "UPT"):
            return lambda st, neg=neg: np.bool_(not neg)
        return (lambda st, a=a: ~st.p.get(a, st.zero.astype(bool))) if neg \
            else (lambda st, a=a: st.p.get(a, st.zero.astype(bool)))

    # -- writes ----------------------------------------------------------
    @staticmethod
    def _set(st, name, val, mask, depth=None):
        if name in ("RZ", "URZ", "PT", "UPT"):
            return
        val = np.asarray(val, dtype=np.uint64) & M32
        old = st.r.get(name)
        st.r[name] = np.where(mask, val, st.zero if old is None else old)
        if depth is not None:
            oldd = st.dep.get(name)
            st.dep[name] = np.where(mask, depth, 0 if oldd is None else oldd)

    @staticmethod
    def _setp(st, name, val, mask):
        if name in ("PT", "UPT"):
            return
        val = np.broadcast_to(np.asarray(val, dtype=bool), (st.n,))
        old = st.p.get(name)
        st.p[name] = np.where(mask, val, False if old is None else old)

    @staticmethod
    def _pair(name: str) -> str:
        m = re.fullmatch(r"(U?R)(\d+)", name)
        return f"{m.group(1)}{int(m.group(2)) + 1}"

    # -- compile one instruction to (kind, fn) -----------------------------
    def _compile(self, ins: Instr):
        op, mods, args = ins.op, set(ins.mods), ins.args
        R = self._reader
        P = self._pred
        dst = args[0].split(".")[0] if args else ""

        def srcs_depth(st, names):
            ds = [st.dep[r] for r in names if r in st.dep]
            if not ds:
                return 0
            return ds[0] if len(ds) == 1 else np.maximum.reduce(ds)

        src_regs = [re.sub(r"\.\w+$", "", x.lstrip("-~|").rstrip("|"))
                    for x in args[1:]]
        src_regs = [x for x in src_regs if re.fullmatch(r"U?R\d+", x)]
        for x in args:
            found = re.findall(r"\[(U?R\d+)", x)
            if found:
                src_regs.append(found[-1])

        def simple(compute):
            def fn(st, mask):
                d = srcs_depth(st, src_regs)
                self._set(st, dst, compute(st), mask, d)
            return fn

        if op in ("NOP", "BSSY", "BSYNC", "BAR", "DEPBAR", "LDGDEPBAR",
                  "WARPSYNC", "ENDCOLLECTIVE"):
            return ("nop", None)
        if op == "EXIT":
            return ("exit", None)
        if op == "BRA":
            target = next((int(a, 16) for a in reversed(args)
                           if a.startswith("0x")), None)
            return ("bra_div" if "DIV" in mods else "bra", target)
        if op == "CALL":
            return ("call", int(args[-1], 16))
        if op == "RET":
            return ("ret", R(args[0]))
        if op in ("MOV", "UMOV", "R2UR"):
            return ("op", simple(R(args[1])))
        if op in ("S2R", "S2UR", "CS2R"):
            src = args[1]
            if op == "CS2R":
                def fn(st, mask, d=dst):
                    self._set(st, d, 0, mask, 0)
                    self._set(st, self._pair(d), 0, mask, 0)
                return ("op", fn)
            return ("op", simple(lambda st, s=src: st.special.get(s, st.zero)))
        if op in ("LDC", "ULDC"):
            rd = R(args[1])
            m = _CONST.match(args[1])
            off = int(m.group(3), 16) if m.group(3) else 0
            reg = m.group(2)
            wide = "64" in mods
            def fn(st, mask, d=dst):
                self._set(st, d, rd(st), mask, 0)
                if wide:
                    if reg:
                        at = st.r.get(reg, st.zero).astype(np.int64) + off + 4
                        hi = st.bank[(at // 4).clip(0, len(st.bank) - 1)]
                    else:
                        hi = st.bank[(off + 4) // 4]
                    self._set(st, self._pair(d), hi, mask, 0)
            return ("op", fn)
        if op in ("IADD3", "UIADD3"):
            _, outs, rest, cins = _split(args)
            x = "X" in mods
            vals, negs = [], []
            for a in rest[:3]:
                reg_neg = a.startswith("-") and not _IMM.match(a)
                if reg_neg and x:
                    vals.append(R("~" + a[1:]))
                    negs.append(False)
                elif reg_neg:
                    vals.append(R(a[1:]))
                    negs.append(True)
                else:
                    vals.append(R(a))
                    negs.append(False)
            cin = [P(a) for a in cins] if x else []
            def fn(st, mask):
                d = srcs_depth(st, src_regs)
                tot = np.uint64(0)
                c1 = np.uint64(0)
                for i, (v, ng) in enumerate(zip(vals, negs)):
                    v = np.asarray(v(st), dtype=np.uint64) & M32
                    if ng:
                        v = (~v & M32) + np.uint64(1)
                    tot = tot + v
                    if i == 1:
                        c1 = tot >> np.uint64(32)
                        tot = tot & M32
                for c in cin:
                    tot = tot + np.asarray(c(st), dtype=np.uint64)
                self._set(st, dst, tot, mask, d)
                c2 = tot >> np.uint64(32)
                if len(outs) == 1:
                    self._setp(st, outs[0], (c1 + c2) > 0, mask)
                elif len(outs) == 2:
                    self._setp(st, outs[0], c1 > 0, mask)
                    self._setp(st, outs[1], c2 > 0, mask)
            return ("op", fn)
        if op == "VIADD":
            a, b = R(args[1]), R(args[2])
            return ("op", simple(lambda st: np.asarray(a(st), np.uint64)
                                 + np.asarray(b(st), np.uint64)))
        if op in ("IMAD", "UIMAD"):
            _, outs, rest, cins = _split(args)
            a, b = R(rest[0]), R(rest[1])
            c = R(rest[2]) if len(rest) > 2 else (lambda st: np.uint64(0))
            signed = "U32" not in mods
            cin = P(cins[0]) if "X" in mods and cins else None
            if "HI" in mods:
                def compute(st):
                    av = np.asarray(a(st), np.uint64)
                    bv = np.asarray(b(st), np.uint64)
                    if signed:
                        prod = _signed(av) * _signed(bv)
                        hi = (prod >> 32).astype(np.uint64) & M32
                    else:
                        prod = av * bv
                        hi = prod >> np.uint64(32)
                    return hi + np.asarray(c(st), np.uint64)
                return ("op", simple(compute))
            if "WIDE" in mods:
                cd = rest[2]
                c_reg = cd.split(".")[0]
                wide_srcs = src_regs + ([self._pair(c_reg)]
                                        if re.fullmatch(r"U?R\d+", c_reg)
                                        else [])
                def fn(st, mask):
                    av = np.asarray(a(st), np.uint64)
                    bv = np.asarray(b(st), np.uint64)
                    if signed:
                        prod = (_signed(av) * _signed(bv)).astype(np.uint64)
                    else:
                        prod = av * bv
                    if cd in ("RZ", "URZ"):
                        cv = np.uint64(0)
                    elif _IMM.match(cd):
                        iv = int(cd, 16)
                        cv = np.uint64(iv & 0xFFFFFFFF)
                        if iv < 0:
                            cv = np.uint64(iv & 0xFFFFFFFFFFFFFFFF)
                    else:
                        lo = st.r.get(c_reg, st.zero)
                        hi = st.r.get(self._pair(c_reg), st.zero)
                        cv = lo | (hi << np.uint64(32))
                    tot = prod + cv
                    d = srcs_depth(st, wide_srcs)
                    self._set(st, dst, tot & M32, mask, d)
                    self._set(st, self._pair(dst), tot >> np.uint64(32),
                              mask, d)
                return ("op", fn)
            def compute(st):
                tot = _u(a(st)) * _u(b(st)) + _u(c(st))
                if cin is not None:
                    tot = tot + np.asarray(cin(st), np.uint64)
                return tot
            return ("op", simple(compute))
        if op in ("LEA", "ULEA"):
            _, preds, rest, cins = _split(args)
            if "HI" in mods:
                sx = "SX32" in mods
                if sx:                       # LEA.HI.X.SX32 d, a, b, s, cin
                    a, b = R(rest[0]), R(rest[1])
                    s = int(rest[2], 16)
                    cin = P(cins[0]) if cins else None
                    def compute(st):
                        av = _u(a(st))
                        hi = np.where(av & np.uint64(0x80000000), M32,
                                      np.uint64(0))
                        full = (hi << np.uint64(32)) | av
                        v = (full << np.uint64(s)) >> np.uint64(32)
                        tot = np.asarray(b(st), np.uint64) + (v & M32)
                        if cin is not None:
                            tot = tot + np.asarray(cin(st), np.uint64)
                        return tot
                else:                        # LEA.HI[.X] d, a, b, c, s[, cin]
                    a, b, c = R(rest[0]), R(rest[1]), R(rest[2])
                    s = int(rest[3], 16)
                    cin = P(cins[0]) if "X" in mods and cins else None
                    def compute(st):
                        full = (_u(c(st)) << np.uint64(32)) | _u(a(st))
                        v = ((full << np.uint64(s)) >> np.uint64(32)) & M32 \
                            if s else np.asarray(c(st), np.uint64)
                        tot = np.asarray(b(st), np.uint64) + v
                        if cin is not None:
                            tot = tot + np.asarray(cin(st), np.uint64)
                        return tot
                def fn(st, mask):
                    d = srcs_depth(st, src_regs)
                    tot = compute(st)
                    self._set(st, dst, tot, mask, d)
                    if preds:
                        self._setp(st, preds[0], (tot >> np.uint64(32)) > 0,
                                   mask)
                return ("op", fn)
            a, b = R(rest[0]), R(rest[1])
            s = int(rest[2], 16)
            def fn(st, mask):
                d = srcs_depth(st, src_regs)
                tot = ((np.asarray(a(st), np.uint64) << np.uint64(s)) & M32) \
                    + np.asarray(b(st), np.uint64)
                self._set(st, dst, tot, mask, d)
                if preds:
                    self._setp(st, preds[0], (tot >> np.uint64(32)) > 0, mask)
            return ("op", fn)
        if op in ("LOP3", "ULOP3"):
            pd = args[0] if _PRED.fullmatch(args[0]) else None
            rest = list(args[1:] if pd else args)
            while rest and _PREDX.fullmatch(rest[-1]):
                rest.pop()
            dd = rest[0].split(".")[0]
            a, b, c = R(rest[1]), R(rest[2]), R(rest[3])
            lut = int(rest[4], 16)
            def compute(st):
                av, bv, cv = (np.asarray(f(st), np.uint64) for f in (a, b, c))
                out = np.zeros_like(av | bv | cv)
                for i in range(8):
                    if lut >> i & 1:
                        t = (av if i & 4 else ~av) & (bv if i & 2 else ~bv) \
                            & (cv if i & 1 else ~cv)
                        out = out | t
                return out & M32
            def fn(st, mask):
                v = compute(st)
                self._set(st, dd, v, mask, srcs_depth(st, src_regs))
                if pd:
                    self._setp(st, pd, v != 0, mask)
            return ("op", fn)
        if op in ("PLOP3", "UPLOP3"):
            d1 = args[0]
            ins_ = [P(x) for x in args[2:5]]
            lut = int(args[5], 16)
            def fn(st, mask):
                av, bv, cv = (np.broadcast_to(f(st), (st.n,)) for f in ins_)
                out = np.zeros(st.n, dtype=bool)
                for i in range(8):
                    if lut >> i & 1:
                        out |= ((av if i & 4 else ~av) & (bv if i & 2 else ~bv)
                                & (cv if i & 1 else ~cv))
                self._setp(st, d1, out, mask)
            return ("op", fn)
        if op in ("SHF", "USHF"):
            lo, s, hi = R(args[1]), R(args[2]), R(args[3])
            left = "L" in mods
            signed = "S32" in mods or "S64" in mods
            wide = "U64" in mods or "S64" in mods
            high = "HI" in mods
            def compute(st):
                lv = np.asarray(lo(st), np.uint64)
                hv = np.asarray(hi(st), np.uint64)
                sv = np.minimum(np.asarray(s(st), np.uint64) & np.uint64(0x3f),
                                np.uint64(32 if not wide else 63))
                if left:
                    full = ((hv << np.uint64(32)) | lv) << sv
                    return (full >> np.uint64(32)) if high else full
                if signed:
                    full = ((hv << np.uint64(32)) | lv).astype(np.int64) >> \
                        sv.astype(np.int64)
                    full = full.astype(np.uint64)
                else:
                    full = ((hv << np.uint64(32)) | lv) >> sv
                if high and not wide:
                    if signed:
                        shift = np.minimum(sv, np.uint64(31)).astype(np.int64)
                        return (_signed(hv) >> shift).astype(np.uint64)
                    return hv >> sv
                return full
            return ("op", simple(lambda st: compute(st) & M32))
        if op == "IABS":
            a = R(args[1])
            return ("op", simple(lambda st: self._mod(a(st), False, False,
                                                      True)))
        if op in ("ISETP", "UISETP"):
            cmp = next(m for m in ins.mods if m in ("GE", "GT", "LE", "LT",
                                                     "EQ", "NE"))
            boolop = next((m for m in ins.mods if m in ("AND", "OR", "XOR")),
                          "AND")
            uns = "U32" in mods
            ex = "EX" in mods
            pd, pd2 = args[0], args[1]
            a, b = R(args[2]), R(args[3])
            pb = P(args[4])
            pc = P(args[5]) if ex else None
            def key(v):
                v = np.asarray(v, np.uint64) & M32
                return v if uns else v ^ np.uint64(0x80000000)
            def fn(st, mask):
                av, bv = key(a(st)), key(b(st))
                if ex:
                    low = pc(st)
                    eq = av == bv
                    above = (av > bv) | (eq & low)
                    below = (av < bv) | (eq & low)
                    r = {"GE": above, "GT": above, "LE": below, "LT": below,
                         "EQ": eq & low, "NE": (~eq) | low}[cmp]
                else:
                    r = {"GE": av >= bv, "GT": av > bv, "LE": av <= bv,
                         "LT": av < bv, "EQ": av == bv, "NE": av != bv}[cmp]
                bb = pb(st)
                comb = {"AND": np.logical_and, "OR": np.logical_or,
                        "XOR": np.logical_xor}[boolop]
                self._setp(st, pd, comb(r, bb), mask)
                self._setp(st, pd2, comb(~np.asarray(r, bool), bb), mask)
            return ("op", fn)
        if op in ("SEL", "USEL", "FSEL"):
            a, b, p = R(args[1]), R(args[2]), P(args[3])
            return ("op", simple(lambda st: np.where(p(st), a(st), b(st))))
        if op == "VIMNMX":
            a, b, p = R(args[1]), R(args[2]), P(args[3])
            uns = "U32" in mods
            def compute(st):
                av = np.asarray(a(st), np.uint64)
                bv = np.asarray(b(st), np.uint64)
                ka = av if uns else av ^ np.uint64(0x80000000)
                kb = bv if uns else bv ^ np.uint64(0x80000000)
                return np.where(p(st), np.where(ka < kb, av, bv),
                                np.where(ka > kb, av, bv))
            return ("op", simple(compute))
        if op == "VIADDMNMX":
            a, b, c, p = R(args[1]), R(args[2]), R(args[3]), P(args[4])
            uns = "U32" in mods
            def compute(st):
                av = (_u(a(st)) + _u(b(st))) & M32
                cv = np.asarray(c(st), np.uint64)
                ka = av if uns else av ^ np.uint64(0x80000000)
                kc = cv if uns else cv ^ np.uint64(0x80000000)
                return np.where(p(st), np.where(ka < kc, av, cv),
                                np.where(ka > kc, av, cv))
            return ("op", simple(compute))
        if op == "I2F" or op == "I2FP":
            a = R(args[1])
            uns = "U32" in mods or "U64" in mods
            w64 = "U64" in mods or "S64" in mods
            up = "RP" in mods
            src = args[1].split(".")[0]
            def compute(st):
                av = np.asarray(a(st), np.uint64)
                if w64:
                    hv = st.r.get(self._pair(src), st.zero)
                    x = hv.astype(np.float64) * 2.0**32 + av.astype(np.float64)
                elif uns:
                    x = av.astype(np.float64)
                else:
                    x = _signed(av).astype(np.float64)
                f = x.astype(np.float32)
                if up:
                    f = np.where(f.astype(np.float64) < x,
                                 np.nextafter(f, np.float32(np.inf)), f)
                return _f32_bits(f)
            return ("op", simple(compute))
        if op == "MUFU":
            a = R(args[1])
            if "RCP" not in mods:
                return ("op", simple(lambda st: np.uint64(0)))
            def compute(st):
                with np.errstate(divide="ignore", over="ignore"):
                    return _f32_bits(np.float32(1.0) / _bits_f32(a(st)))
            return ("op", simple(compute))
        if op == "F2I":
            a = R(args[1])
            w64 = "U64" in mods or "S64" in mods
            def fn(st, mask):
                with np.errstate(invalid="ignore", over="ignore"):
                    f = np.trunc(_bits_f32(a(st)).astype(np.float64))
                    f = np.nan_to_num(f, nan=0.0, posinf=2.0**64 - 1, neginf=0)
                    f = np.clip(f, -2.0**63, 2.0**64 - 1)
                    v = np.where(f < 0, (f.astype(np.int64)).astype(np.uint64),
                                 f.astype(np.uint64))
                d = srcs_depth(st, src_regs)
                self._set(st, dst, v & M32, mask, d)
                if w64:
                    self._set(st, self._pair(dst), v >> np.uint64(32), mask, d)
            return ("op", fn)
        if op in ("FADD", "FMUL", "FFMA"):
            # data only: no branch of these kernels reads a float result
            def fn(st, mask, d=dst):
                self._set(st, d, 0, mask)
            return ("arith", fn)
        if op == "HFMA2" and is_const_move(ins):
            lo_hi = [x for x in args[3:5]]
            bits = 0
            try:
                h = [int(np.float16(float(x.replace("INF", "inf")))
                         .view(np.uint16)) for x in lo_hi]
                bits = (h[0] << 16) | h[1]
            except ValueError:
                bits = 0
            return ("op", simple(lambda st, b=bits: np.uint64(b)))
        if op in ("HFMA2", "F2F", "F2FP", "PRMT", "HMMA", "SHFL", "UBREV",
                  "UFLO", "P2R"):
            return self._compile_data(ins)
        if op in ("LDG", "LDS", "LDSM", "LDGSTS", "STG", "STS"):
            return ("mem", None)
        raise UnknownSassError(
            f"{self.name}: SASS opcode {ins.text!r} at {ins.addr:#x} is not "
            f"modeled by the emulator")

    def _compile_data(self, ins: Instr):
        """Instructions whose results are data (or bit tricks the kernels use
        for control: bit reverse, find-leading-one, predicate packing)."""
        op, args, mods = ins.op, ins.args, set(ins.mods)
        R = self._reader
        dst = args[0].split(".")[0] if args else ""
        if op in ("UBREV", "UFLO", "P2R"):
            return ("op", self._bits(op, args, mods, dst))
        if op == "SHFL":
            preds = [x for x in args if re.fullmatch(r"U?P[T0-9]", x)]
            rest = [x for x in args if x not in preds]
            src = R(rest[1])
            pd = args[0] if args[0] in preds else None
            def fn(st, mask):
                self._set(st, rest[0].split(".")[0], src(st), mask, 0)
                if pd:
                    self._setp(st, pd, True, mask)
            return ("op", fn)
        width = 4 if op == "HMMA" else 1
        kind = "arith" if arith_weight(ins) else "op"
        def fn(st, mask):
            for i in range(width):
                name = dst if i == 0 else re.sub(
                    r"\d+$", lambda m, i=i: str(int(m.group()) + i), dst)
                self._set(st, name, 0, mask, 0)
        return (kind, fn)

    def _bits(self, op: str, args, mods, dst: str):
        """Bit reverse (``UBREV``), find leading one (``UFLO``; ``.SH``: the
        shift that brings it to bit 31) and predicate packing (``P2R``):
        the kernels use them for ``__ffs`` and to keep predicates across
        calls."""
        a = self._reader(args[2] if op == "P2R" else args[1])
        one = np.uint64(1)

        def compute(st):
            v = _u(a(st)) & M32
            if op == "UBREV":
                out = np.zeros_like(v)
                for i in range(32):
                    out |= ((v >> np.uint64(i)) & one) << np.uint64(31 - i)
                return out
            if op == "UFLO":
                pos = np.full(v.shape, -1, dtype=np.int64)
                for i in range(32):
                    pos = np.where((v >> np.uint64(i)) & one, i, pos)
                if "SH" in mods:
                    pos = np.where(pos >= 0, 31 - pos, -1)
                return pos.astype(np.uint64) & M32
            m = np.uint64(int(args[3], 16))
            bits = np.zeros(st.n, dtype=np.uint64)
            for i in range(7):
                p = st.p.get(f"P{i}")
                if p is not None:
                    bits |= p.astype(np.uint64) << np.uint64(i)
            return (v & ~m) | (bits & m)

        return lambda st, mask: self._set(st, dst, compute(st), mask, 0)

    # -- run ---------------------------------------------------------------
    def _mem_info(self, ins: Instr):
        """(class, bytes, address registers, destination registers) of a
        memory instruction."""
        addr = []
        for a in ins.args:
            found = re.findall(r"\[(U?R\d+)", a)
            if found:
                addr.append(found[-1])
        dests = []
        mm = re.fullmatch(r"(U?R)(\d+)", ins.args[0].split(".")[0]) \
            if ins.op in ("LDG", "LDS", "LDSM") else None
        if mm:
            dests = [f"{mm.group(1)}{int(mm.group(2)) + k}"
                     for k in range(max(access_bytes(ins) // 4, 1))]
        return classify(ins), access_bytes(ins), addr, dests

    def run(self, grid, block: int, params: bytes) -> LaunchCounts:
        """Execute one launch of ``grid`` (x or (x, y)) CTAs of ``block``
        threads with the packed ``params``; returns its counts."""
        grid = (grid, 1) if isinstance(grid, int) else tuple(grid)
        pad = -(-block // 32) * 32
        n = grid[0] * grid[1] * pad
        warps = n // 32
        st = _State(n, block, grid, params)
        alive = st.alive.copy()
        n_alive = int(alive.sum())
        warps_alive = int(alive.reshape(warps, 32).any(axis=1).sum())
        counts = LaunchCounts()
        ops_by: dict[str, int] = {}
        index, instrs, compiled = self.index, self.instrs, self._compiled
        mem = self._mem
        # converged: every live thread at one address (``cur``); else each
        # thread's own address in ``pc``
        cur = self.instrs[0].addr
        pc = None
        zero_dep = np.zeros(n, np.int64)
        while True:
            if pc is not None:
                m = int(pc.min())
                if m >= _DONE:
                    break
                sel = pc == m
                nsel = int(np.count_nonzero(sel))
                if nsel == n_alive:           # the threads met again
                    pc, cur = None, m
                    sel = alive
                    nwarps = warps_alive
                else:
                    nwarps = int(np.count_nonzero(
                        sel.reshape(warps, 32).any(axis=1)))
            else:
                m = cur
                if m >= _DONE:
                    break
                sel, nsel, nwarps = alive, n_alive, warps_alive
            i = index.get(m)
            if i is None:
                raise UnknownSassError(f"{self.name}: jump to {m:#x}, "
                                       f"which holds no instruction")
            ins = instrs[i]
            kind, fn = compiled[i]
            guard = self._guards[i]
            ex = sel & guard(st) if guard is not None else sel
            nex = int(np.count_nonzero(ex)) if guard is not None else nsel
            counts.thread_instructions += nsel
            counts.warp_instructions += nwarps
            ops_by[ins.op] = ops_by.get(ins.op, 0) + nsel
            target = None                     # per-thread next address
            if kind in ("bra", "call", "exit", "ret"):
                counts.other += nsel
                if kind == "bra" and m in self.loop_starts:
                    start = self.loop_starts[m]
                    counts.loop_trips[start] = \
                        counts.loop_trips.get(start, 0) + nex
                if kind == "ret":
                    target = np.asarray(fn(st), np.uint64).astype(np.int64)
                else:
                    target = _DONE if kind == "exit" else fn
                if kind == "exit" and nex:
                    alive = alive & ~ex
                    n_alive -= nex
                    warps_alive = int(alive.reshape(warps, 32).any(axis=1)
                                      .sum())
            elif kind == "mem":
                cls, nbytes, addr, dests = mem[i]
                if cls == "load":
                    counts.load_bytes += nbytes * nex
                elif cls == "store":
                    counts.store_bytes += nbytes * nex
                else:
                    counts.shared_bytes += nbytes * nex
                if dests and nex:
                    deps = [st.dep[r] for r in addr if r in st.dep]
                    d = (np.maximum.reduce(deps) if len(deps) > 1 else
                         deps[0] if deps else zero_dep) + 1
                    counts.load_chain = max(counts.load_chain,
                                            int(d[ex].max()))
                    for r in dests:
                        self._set(st, r, 0, ex, d)
            else:
                if kind == "arith":
                    counts.arith += arith_weight(ins) * nex
                else:
                    counts.other += nsel
                if kind == "bra_div":       # the warp is converged: not taken
                    fn = None
                if fn is not None and nex:
                    fn(st, ex)
            # the next address of the threads at this one
            if target is None or (nex == 0):
                nxt_all = m + 16
                if pc is None:
                    cur = nxt_all
                else:
                    pc = np.where(sel, nxt_all, pc)
            elif nex == nsel and not isinstance(target, np.ndarray):
                if pc is None:
                    cur = int(target)
                else:
                    pc = np.where(sel, np.int64(target), pc)
            else:
                base = np.full(n, cur, np.int64) if pc is None else pc
                pc = np.where(ex, target, np.where(sel, m + 16, base))
                pc = np.where(alive, pc, _DONE)
        counts.opcodes = ops_by
        return counts


_emulators: dict[tuple, Emulator] = {}


def emulator_for(kernel: str, lines: list[str]) -> Emulator:
    """A (cached) emulator of one kernel's SASS lines."""
    key = (kernel, hash(tuple(lines)))
    emu = _emulators.get(key)
    if emu is None:
        emu = _emulators[key] = Emulator(decode(lines), kernel)
    return emu
