"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `dynamo_tpu_torch/csrc/<name>.cu` compiles on its own into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Builds run at first use, never at import, into `build/
torch_kernels/` at the repository root, keyed by a hash of the source, the
shared headers and the flags, so an edited source rebuilds. A missing
nvcc or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
#: one shared library per kernel source
SOURCES = ("kv_update", "flash_prefill", "paged_attention", "paged_prefill", "int8_matmul")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}
#: ctypes argument types: pointers and the stream as void*, sizes as int,
#: buffer lengths as long long
PTR, INT, FLOAT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            found = str(cand)
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of dynamo_tpu_torch are built "
            "from dynamo_tpu_torch/csrc at first use and need the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def library_path(name: str) -> Path:
    """Where library `name` is built: keyed by its source, the shared
    headers (csrc/*.cuh) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start one nvcc; returns (process, output path, tmp path) or None
    when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, out, tmp


def _finish(name: str, started) -> str:
    proc, out, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=SOURCES) -> dict[str, dict]:
    """Build every named kernel library in parallel (one nvcc each, all
    started together). Returns {name: {"seconds", "ptxas"}}; a library
    that was already built reports 0 seconds and no ptxas lines."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        report = {}
        for n, st in started.items():
            if st is None:
                report[n] = {"seconds": 0.0, "ptxas": []}
                continue
            log = _finish(n, st)
            report[n] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [
                    line for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "Compiling entry" in line
                ],
            }
        return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of library `name` (built on first use),
    returning a cudaError_t; its argument types are set once."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = _fns[symbol] = entry(load(name), symbol, argtypes)
    return fn


def build_variants(srcs: dict[str, str | Path], out_dir: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile each named CUDA source with the kernels' flags and csrc/ on
    the include path, one nvcc each, all started together, into
    `out_dir/lib<name>.so` (for timing builds of one kernel against each
    other). A source given as text is written to `out_dir/<name>.cu`; a
    file is compiled where it lies, so the headers beside it come before
    csrc/'s. Returns name -> (loaded library, nvcc's log with ptxas's
    report); a failed build raises."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = src if isinstance(src, Path) else out_dir / f"{name}.cu"
        if not isinstance(src, Path):
            cu.write_text(src)
        cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(out_dir / f"lib{name}.so")), log)
    return built


def variant_sources(name: str, extra: list[str]) -> dict[str, Path]:
    """Sources for `build_variants`: `committed` (csrc/<name>.cu) and, for
    each `NAME=PATH` in `extra`, that file (e.g. an earlier design of the
    kernel in a `git archive` of its commit's csrc/, so that it builds
    against its own headers). Raises ValueError for an entry that is not
    NAME=PATH, a NAME given twice, or a PATH that is not a file."""
    out = {"committed": CSRC / f"{name}.cu"}
    for item in extra:
        label, _, path = item.partition("=")
        if not path or label in out or not Path(path).is_file():
            raise ValueError(f"--source takes a new NAME=PATH of a file, not {item!r}")
        out[label] = Path(path).resolve()
    return out


def ptxas_registers(log: str) -> dict[str, int]:
    """Registers per kernel instance in nvcc's log (ptxas -v), keyed by the
    instance's mangled name."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            out[current] = int(m.group(1))
            current = None
    return out


def entry(lib: ctypes.CDLL, symbol: str, argtypes: list):
    """C entry point `symbol` of a loaded library, returning a cudaError_t."""
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer; None is the null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
