"""Build and load the port's hand-written CUDA kernels.

Route: ``nvcc`` -> a shared library with a plain C interface -> ``ctypes``.
Each kernel package declares one ``KernelLibrary``: its ``csrc/`` directory,
the C entry point of every source (with its ``ctypes`` argument types) and
the headers its sources include.  A source is compiled at first use, for
``sm_90a``, into ``build/<package>/`` at the checkout's root; the library's
name carries a hash of the source, its headers and the flags, so a changed
source never loads a stale build.  ``build_libraries`` starts one ``nvcc``
per missing library, for all the packages it is given, and waits for all.
Nothing is built or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: src/repro_torch/kernels/build.py -> the checkout's root
ROOT = Path(__file__).resolve().parents[3]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME / "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


class KernelLibrary:
    """The CUDA sources of one kernel package and their loaded libraries.

    ``entries`` maps a source file (relative to ``csrc``) to the name of its
    C entry point and that function's ``ctypes`` argument types; every entry
    point returns ``cudaGetLastError()`` as an int.  ``headers`` are the
    files of ``csrc`` that every source includes (hashed with each
    source)."""

    def __init__(self, name: str, csrc: Path, entries: dict[str, tuple],
                 headers: tuple[str, ...] = ()):
        self.name = name
        self.csrc = Path(csrc)
        self.entries = entries
        self.headers = headers
        #: source -> loaded library (empty until the first launch)
        self.libs: dict[str, ctypes.CDLL] = {}
        #: seconds the last build that compiled anything of this library took
        #: (0.0 when every library was current)
        self.last_build_seconds = 0.0

    @property
    def build_dir(self) -> Path:
        return ROOT / "build" / self.name

    def lib_path(self, source: str) -> Path:
        """Content-addressed library path of ``source``."""
        h = hashlib.sha256()
        for f in (source, *self.headers):
            h.update((self.csrc / f).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return self.build_dir / f"lib{Path(source).stem}-{h.hexdigest()[:12]}.so"

    def build_all(self) -> dict[str, Path]:
        """Compile every source of this package that has no current library;
        returns source -> library path."""
        return build_libraries((self,))[self.name]

    def entry(self, source: str):
        """The C entry point of ``source``, building and loading at first
        use."""
        name, argtypes = self.entries[source]
        lib = self.libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(self.build_all()[source]))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.libs[source] = lib
        return getattr(lib, name)


def build_libraries(libraries) -> dict[str, dict[str, Path]]:
    """Compile every source of ``libraries`` that has no current library, all
    ``nvcc`` processes started together.  Each library gets a ``.log`` beside
    it with the command and the compiler's output (``-Xptxas -v``: registers,
    shared memory, spills).  Raises with the compiler's output if one fails.
    Returns package name -> source -> library path."""
    paths = {lib.name: {src: lib.lib_path(src) for src in sorted(lib.entries)}
             for lib in libraries}
    todo = [(lib, src, path) for lib in libraries
            for src, path in paths[lib.name].items() if not path.exists()]
    for lib in libraries:
        lib.last_build_seconds = 0.0
    if not todo:
        return paths
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for lib, src, path in todo:
        lib.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(lib.csrc / src)]
        procs.append((path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for path, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\nexit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    seconds = time.perf_counter() - t0
    for lib in {lib.name: lib for lib, _, _ in todo}.values():
        lib.last_build_seconds = seconds
    if failures:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n"
                           + "\n".join(failures))
    return paths


def launch(fn, x, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` with the device of tensor x
    current and on that device's current stream; returns its
    ``cudaGetLastError()``.  The host's share of a timed call is kept small:
    the device is switched only when it is not the current one already, and
    the stream is read as a raw handle (no ``torch.cuda.Stream`` object is
    made)."""
    import torch
    dev = x.device.index
    if dev == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err} "
                           f"(cudaGetLastError)")
