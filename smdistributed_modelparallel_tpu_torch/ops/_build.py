"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (listed
in ``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags so an edited source is rebuilt, and loaded
with ``ctypes``. Nothing is built when the package is imported, and nothing
falls back when a build fails: the error carries nvcc's output.

A first load in a process is the port's compile: it runs under the telemetry
phase ``compile/<name>`` (the goodput ledger's ``compile_fresh``), then the
phase it interrupted comes back. The flight recorder and the ledger get its
seconds: ``nvcc`` for a build (fresh), ``load`` for a library already on
disk (the ledger moves those seconds to ``compile_cache``, as it does for the
JAX package's disk-cache hits). ``COMPILE_EVENTS`` lists every first load of
the process as ``{"source": "fresh" | "disk_cache", "name", "seconds"}``,
the JAX package's compile-event sources: what a serving replica's warm start
reports (``utils/exec_cache.compile_events_since``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from smdistributed_modelparallel_tpu_torch.utils.flight_recorder import flight_recorder
from smdistributed_modelparallel_tpu_torch.utils.goodput import goodput
from smdistributed_modelparallel_tpu_torch.utils.telemetry import telemetry

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED = {}
_LOCK = threading.Lock()
COMPILE_EVENTS = []  # every first load of this process, in order


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use."
    )


def _target(name):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def start_build(name):
    """Start nvcc for ``csrc/<name>.cu``; return ``(Popen, out_path)``, or
    ``(None, out_path)`` when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, out


def finish_build(proc, out):
    """Wait for a build from ``start_build``; return nvcc's output."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return log


def build_all(names):
    """Build every named source at once (one nvcc each, all started
    together); return ``{name: nvcc output}``."""
    started = {n: start_build(n) for n in names}
    return {n: finish_build(*started[n]) for n in names}


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            resumed = telemetry.phase
            telemetry.set_phase(f"compile/{name}")
            t0 = time.perf_counter()
            try:
                proc, out = start_build(name)
                finish_build(proc, out)
                lib = _LOADED[name] = ctypes.CDLL(str(out))
            finally:
                telemetry.set_phase(resumed)
            seconds = time.perf_counter() - t0
            source = "fresh" if proc is not None else "disk_cache"
            flight_recorder.record_compile("nvcc" if proc is not None else "load", name, seconds)
            goodput.note_compile(source, seconds)
            COMPILE_EVENTS.append({"source": source, "name": name, "seconds": seconds})
        return lib
