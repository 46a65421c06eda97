"""Builds the CUDA kernels of `csrc/` with nvcc and loads them with ctypes.

Each source becomes one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The build happens once per process, at first use (or up front through
`build()`, which starts one nvcc per source, all at once), into
`build/kernels/` under the repository root. The file name carries a hash
of the sources and flags, so an edited kernel is rebuilt and a stale
library is never loaded. `build_variants()` builds one source with extra
flags (`-D` values of its tuning macros) beside the default library. A
missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

SOURCES = ("flash_attention", "decode_attention", "int8_matmul",
           "queue_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}   # (name, extra flags) -> CDLL
LOGS: dict = {}   # nvcc's output of each build this process ran


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else nvcc on PATH,
    else /usr/local/cuda/bin/nvcc. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are built from source at first use")


def _lib_path(name: str, flags: tuple = ()) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict:
    """Build (if needed) and load the named kernels; one nvcc process per
    missing library, all started together. Returns {name: CDLL}."""
    libs = build_variants([(n, ()) for n in names], verbose=verbose)
    return {n: libs[(n, ())] for n in names}


def build_variants(variants, *, verbose: bool = False) -> dict:
    """Build (if needed) and load each (name, extra nvcc flags) pair; one
    nvcc process per missing library, all started together. With
    `verbose`, ptxas reports registers and spills, kept in LOGS[name] for
    the default flags. Returns {(name, flags): CDLL}."""
    todo = [(n, tuple(f)) for n, f in variants]
    todo = [v for i, v in enumerate(todo)
            if v not in _LIBS and v not in todo[:i]]
    procs = []
    for n, f in todo:
        out = _lib_path(n, f)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *f]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, f, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, f, out, tmp, p in procs:
        log, _ = p.communicate()
        if not f:
            LOGS[n] = log
        what = f"{n}.cu {' '.join(f)}".strip()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {what} (exit {p.returncode}):\n"
                          f"{log}")
            continue
        if verbose and log:
            print(f"[nvcc {what}]\n{log}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    for n, f in todo:
        _LIBS[(n, f)] = ctypes.CDLL(str(_lib_path(n, f)))
    return {(n, tuple(f)): _LIBS[(n, tuple(f))] for n, f in variants}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    return build((name,))[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
