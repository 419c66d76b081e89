"""Multi-process coordination for the ``distributed`` backend (paper Fig 4
past one process), on ``torch.distributed``.

Counterpart of ``repro.bench.distributed``.  Three concerns live here, apart
from the backend itself (``bench.backends.DistributedBackend`` — the mesh and
its placement):

* **initialization** — ``ensure_initialized(device)`` wraps
  ``torch.distributed.init_process_group`` with env-var autodetection
  (``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``,
  falling back to torchrun's ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` /
  ``RANK``).  The collective backend follows the run's explicit device:
  gloo for the CPU, NCCL for CUDA.  A CUDA run whose NCCL cannot start
  raises; nothing switches to gloo.
* **gathering** — ``gather_result()`` all-gathers every process's per-point
  timings, rank-tagged, and merges them into ONE BenchResult: each merged
  point takes the *slowest* process's timing triple (aggregate bandwidth =
  global bytes / the straggler's wall time), the per-process means land in
  ``meta["per_process_mean_s"]``, and the machine meta records
  ``process_count``, the per-process ``local_device_counts`` and the global
  ``device_count`` (result schema v3).
* **launching** — ``launch_local()`` spawns N coordinated local processes.
  Where the reference forces K host devices on each child with
  ``XLA_FLAGS``, each child here gets its devices from the environment: on
  the CPU ``REPRO_TORCH_CPU_DEVICES=K`` logical devices, on CUDA its own
  ``CUDA_VISIBLE_DEVICES`` slice of K GPUs (no two children share a GPU, and
  a launch asking for more GPUs than are visible raises before it spawns).
  This is the path behind ``python -m repro_torch.bench launch``.  On a real
  cluster skip the launcher: start one process per host with the env vars
  set (or under torchrun) and the same ``run --backend distributed``
  command.
"""
from __future__ import annotations

import atexit
import os
import socket
import subprocess
import sys
import threading
import time

from repro_torch.obs import metrics, trace

#: env vars read by ``env_info``: the REPRO_* name first, then torchrun's
#: (the coordinator falls back to ``MASTER_ADDR:MASTER_PORT``, both set)
ENV_COORDINATOR = ("REPRO_COORDINATOR", "MASTER_ADDR", "MASTER_PORT")
ENV_NUM_PROCESSES = ("REPRO_NUM_PROCESSES", "WORLD_SIZE")
ENV_PROCESS_ID = ("REPRO_PROCESS_ID", "RANK")

#: every process's local device count, by rank, once gathered (the topology
#: of a process group does not change while it lives)
_local_counts: list[int] | None = None


def _env(names, cast=str):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return cast(v)
    return None


def env_info() -> tuple[str | None, int | None, int | None]:
    """(coordinator_address, num_processes, process_id) from the environment;
    None where unset.  The launcher sets the REPRO_* triple on every child."""
    coord = _env(ENV_COORDINATOR[:1])
    if coord is None:
        addr, port = (_env((n,)) for n in ENV_COORDINATOR[1:])
        if addr is not None and port is not None:
            coord = f"{addr}:{port}"
    return (coord, _env(ENV_NUM_PROCESSES, int), _env(ENV_PROCESS_ID, int))


def env_active() -> bool:
    """True when this process was started under a multi-process launcher."""
    coord, nproc, _ = env_info()
    return coord is not None and (nproc or 1) > 1


def is_initialized() -> bool:
    import torch.distributed as tdist
    return tdist.is_available() and tdist.is_initialized()


def _shutdown() -> None:
    global _local_counts
    _local_counts = None
    if is_initialized():
        import torch.distributed as tdist
        tdist.destroy_process_group()


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               device=None) -> None:
    """``torch.distributed.init_process_group`` over TCP at
    ``coordinator_address`` (``host:port``; process 0 serves it), with gloo
    when ``device`` (None = ``cuda``) is the CPU and NCCL when it is CUDA —
    the CUDA device is made current first, since NCCL runs on it."""
    import torch
    import torch.distributed as tdist

    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)        # raises: no silent CPU run
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        backend = "nccl"
    else:
        backend = "gloo"
    tdist.init_process_group(backend,
                             init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id)
    atexit.register(_shutdown)


def ensure_initialized(device=None) -> bool:
    """Autodetect the coordination env and initialize once; no-op (False)
    outside a launch, True when running under one.  Unlike the reference it
    also starts a one-process group when the launcher started one process,
    so that ``launch --processes 1`` runs the collectives too."""
    if is_initialized():
        return True
    coord, nproc, pid = env_info()
    if coord is None or not nproc:
        return False
    if pid is None:
        if nproc > 1:
            raise RuntimeError(
                f"{ENV_NUM_PROCESSES[0]}={nproc} but no process id; set "
                f"{ENV_PROCESS_ID[0]} (the launcher does this per child)")
        pid = 0
    initialize(coord, nproc, pid, device)
    return True


def process_count() -> int:
    if not is_initialized():
        return 1
    import torch.distributed as tdist
    return tdist.get_world_size()


def process_index() -> int:
    if not is_initialized():
        return 0
    import torch.distributed as tdist
    return tdist.get_rank()


def is_primary() -> bool:
    """True on the process that should print/save gathered results."""
    return process_index() == 0


def _all_gather(obj) -> list:
    """``obj`` of every process, in rank order."""
    import torch.distributed as tdist
    out = [None] * process_count()
    tdist.all_gather_object(out, obj)
    return out


def local_device_counts(device=None) -> list[int]:
    """Every process's device pool size for ``device``, in rank order (one
    entry outside a launch)."""
    global _local_counts
    from repro_torch.core.device import device_pool
    if process_count() == 1:
        return [len(device_pool(device))]
    if _local_counts is None:
        _local_counts = [int(n) for n in
                         _all_gather(len(device_pool(device)))]
    return _local_counts


#: the canonical Fig-4 device-count ladder
DEVICE_LADDER = (1, 2, 4, 8, 16, 32, 64)


def covering_device_counts(ladder=DEVICE_LADDER, device=None
                           ) -> tuple[int, ...]:
    """The ladder values usable as a distributed mesh size here: every
    process must own >= 1 shard (so counts below the process count drop
    out) and the count can't exceed the global device total.  When no
    ladder value qualifies (e.g. 3 processes x 1 device), the full global
    mesh always covers, so it is the fallback."""
    total = sum(local_device_counts(device))
    counts = tuple(k for k in ladder if process_count() <= k <= total)
    return counts or (total,)


# ---------------------------------------------------------------------------
# gathering
# ---------------------------------------------------------------------------

def gather_result(res):
    """Merge every process's copy of ``res`` into one global BenchResult.

    Every process runs the identical SPMD measurement loop, so the point
    lists line up index for index; only the timings differ.  The merged
    point takes the timing triple of the process with the largest mean —
    aggregate bandwidth is global bytes over the straggler's wall time — and
    gbps / gflops are recomputed from it.  Per-process means are kept in
    ``meta["per_process_mean_s"]`` (rank-indexed rows, point-indexed
    columns) and the machine meta grows ``process_count``, the per-process
    ``local_device_counts`` and the global ``device_count``.  Identity (and
    the input object) on a one-process run."""
    n = process_count()
    if n == 1:
        return res
    import dataclasses

    # one gather for all points, each row tagged with its sender's rank so
    # the merge order never depends on the collective's ordering
    rows = _all_gather((process_index(),
                        int(res.machine["local_device_count"]),
                        [(p.mean_s, p.std_s, p.min_s) for p in res.points]))
    rows.sort(key=lambda r: r[0])
    merged = []
    for i, p in enumerate(res.points):
        slowest = max(range(n), key=lambda r: rows[r][2][i][0])
        mean_s, std_s, min_s = (float(v) for v in rows[slowest][2][i])
        merged.append(dataclasses.replace(
            p, mean_s=mean_s, std_s=std_s, min_s=min_s,
            gbps=p.bytes_per_call / mean_s / 1e9 if mean_s else 0.0,
            gflops=p.flops_per_call / mean_s / 1e9 if mean_s else 0.0))
    res.points = merged
    res.meta["per_process_mean_s"] = [[s[0] for s in r[2]] for r in rows]
    res.machine["process_count"] = n
    res.machine["local_device_counts"] = [r[1] for r in rows]
    res.machine["device_count"] = sum(r[1] for r in rows)
    _gather_traces()
    return res


def _gather_traces() -> None:
    """All-gather every process's span-trace events and install the merged
    stream (pids re-stamped to ranks) on ALL processes — process 0 then
    writes ONE trace showing every rank, stragglers included.  A no-op while
    tracing is disabled (nothing is gathered, zero cost)."""
    tr = trace.get_tracer()
    if not tr.enabled or process_count() == 1:
        return
    rank = process_index()
    events = tr.events()
    for e in events:        # stamp mesh identity before the OS pid is lost
        e["pid"] = rank
    streams: list[list[dict]] = [[] for _ in range(process_count())]
    for r, evs in _all_gather((rank, events)):
        streams[r] = evs
    tr.replace_events(trace.merge_process_traces(streams))


# ---------------------------------------------------------------------------
# local launcher (single-machine multi-process runs)
# ---------------------------------------------------------------------------

def pick_free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(proc, prefix, sink):
    for line in proc.stdout:
        sink.write(f"{prefix}{line}")
        sink.flush()


def _visible_gpus(env: dict) -> list[str]:
    """The GPUs a child may be given: ``CUDA_VISIBLE_DEVICES``'s entries
    where the launching environment sets it, else every device this
    process sees."""
    if "CUDA_VISIBLE_DEVICES" in env:
        return [s.strip() for s in env["CUDA_VISIBLE_DEVICES"].split(",")
                if s.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


def launch_local(cmd: list[str], processes: int,
                 devices_per_process: int = 1,
                 coordinator_port: int | None = None,
                 env: dict | None = None, timeout: float | None = None,
                 stream_to=None, device=None) -> int:
    """Spawn ``cmd`` as ``processes`` coordinated local processes.

    Each child gets the REPRO_* coordination triple and
    ``devices_per_process`` devices of the kind ``device`` names (None =
    ``cuda``): ``REPRO_TORCH_CPU_DEVICES`` logical devices on the CPU (and,
    unless the environment sets ``OMP_NUM_THREADS``, an equal share of the
    host's cores), its own ``CUDA_VISIBLE_DEVICES`` slice on CUDA, where
    ``processes *
    devices_per_process`` above the visible GPUs raises ``BenchSpecError``
    before anything is spawned.  The global mesh the children see has
    ``processes * devices_per_process`` devices.  Child stdout/stderr are
    streamed line by line with a ``[pK]`` prefix.  Returns the max child
    return code; on the first failure — *whichever* child fails first — the
    stragglers are killed rather than left waiting at a collective, and a
    ``timeout`` (seconds, for the whole launch) likewise kills everything
    and reports nonzero instead of raising.
    """
    import torch

    from repro_torch.bench.spec import BenchSpecError
    from repro_torch.core.device import CPU_DEVICES_ENV
    if processes < 1:
        raise ValueError(f"processes must be >= 1: {processes}")
    if devices_per_process < 1:
        raise ValueError(
            f"devices_per_process must be >= 1: {devices_per_process}")
    kind = torch.device("cuda" if device is None else device).type
    base = dict(env if env is not None else os.environ)
    want = processes * devices_per_process
    per_child: list[dict] = []
    if kind == "cuda":
        gpus = _visible_gpus(base)
        if want > len(gpus):
            raise BenchSpecError(
                f"launch of {processes} process(es) x {devices_per_process} "
                f"GPU(s) needs {want} GPUs; {len(gpus)} visible (no two "
                f"processes share a GPU)"
                + ("" if gpus else "; pass --device cpu to launch on the "
                                   "CPU (gloo)"))
        per_child = [{"CUDA_VISIBLE_DEVICES": ",".join(
            gpus[i * devices_per_process:(i + 1) * devices_per_process])}
            for i in range(processes)]
    elif kind == "cpu":
        cpu = {CPU_DEVICES_ENV: str(devices_per_process)}
        if "OMP_NUM_THREADS" not in base:
            # an equal share of the host's cores each: on 8 cores a
            # 2-process gloo launch took 115 s with two 8-thread pools and
            # 6.5 s with one thread each
            cpu["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1)
                                             // processes))
        per_child = [cpu] * processes
    else:
        raise ValueError(f"launch_local: device {device!r} is neither cuda "
                         f"nor cpu")
    port = coordinator_port or pick_free_port()
    sink = stream_to or sys.stderr
    procs, pumps = [], []
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    tr = trace.get_tracer()
    launch_span = tr.span("launch.local", cat="launch", processes=processes,
                          devices_per_process=devices_per_process,
                          device=kind)
    launch_span.__enter__()
    try:
        # spawn INSIDE the cleanup scope: a Popen failure partway through
        # (EMFILE, OOM) must not leak already-started children blocked at
        # the rendezvous
        for i in range(processes):
            child_env = dict(base, **per_child[i],
                             REPRO_COORDINATOR=f"127.0.0.1:{port}",
                             REPRO_NUM_PROCESSES=str(processes),
                             REPRO_PROCESS_ID=str(i))
            p = subprocess.Popen(cmd, env=child_env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            procs.append(p)
            t = threading.Thread(target=_pump, args=(p, f"[p{i}] ", sink),
                                 daemon=True)
            t.start()
            pumps.append(t)
        # poll ALL children (a sequential wait would hang on a live earlier
        # child blocked at a collective while a later one lies dead)
        pending = set(procs)
        while pending:
            for p in list(pending):
                code = p.poll()
                if code is not None:
                    pending.discard(p)
                    if code:    # negative = killed by signal, still a failure
                        rc = max(rc, code if code > 0 else 1)
            if rc:          # a dead peer wedges the others at a collective
                break
            if deadline is not None and time.monotonic() > deadline:
                sink.write(f"# launch_local: timeout after {timeout}s, "
                           f"killing {len(pending)} process(es)\n")
                tr.event("launch.timeout", cat="launch", timeout_s=timeout,
                         pending=len(pending))
                rc = 1
                break
            if pending:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc = max(rc, 1)
                metrics.REGISTRY.inc("straggler_kills")
                tr.event("launch.straggler_kill", cat="launch",
                         process=procs.index(p), rc=rc)
        launch_span.__exit__(None, None, None)
    for t in pumps:
        t.join(timeout=5)
    return rc
