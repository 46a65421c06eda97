"""The scan engine's open-loop queue recurrence: wrapper of the CUDA
kernel `csrc/queue_scan.cu`.

The kernel replaces no Pallas kernel: the reference runs the recurrence
as a `lax.scan` (src/repro/serving/scan_engine.py:727). One thread runs
the dependent chain, looping over the servers' free times (in shared
memory, or in a device buffer where there are too many servers for it),
while the block's other warps stage the next chunk of inputs into shared
memory. Any number of servers. Bit for bit the python event loop: no
products, only fp64 compares, max, add and subtract.

`queue_scan` launches the kernel for CUDA tensors (or raises) and runs
the plain version `kernels.ref.queue_scan_ref` for CPU tensors, nowhere
else. `queue_scan.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref as R

_C = ctypes


@functools.cache
def _lib():
    lib = _build.load("queue_scan")
    lib.queue_scan_fwd.argtypes = ([_C.c_void_p] * 5
                                   + [_C.c_longlong, _C.c_int, _C.c_double]
                                   + [_C.c_void_p] * 4)
    lib.queue_scan_fwd.restype = _C.c_int
    lib.queue_scan_fp64_add_cycles.argtypes = [_C.c_longlong] + [
        _C.c_void_p] * 3
    lib.queue_scan_fp64_add_cycles.restype = _C.c_int
    return lib


def fp64_add_cycles(iters: int = 1 << 16) -> float:
    """SM cycles of one dependent fp64 add on the current CUDA device
    (one thread, iters x 16 adds between two clock reads): the latency
    that the recurrence's bound counts for each link of a step."""
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(_lib().queue_scan_fp64_add_cycles(
        iters, cycles.data_ptr(), sink.data_ptr(), stream),
        "queue_scan_fp64_add_cycles")
    return int(cycles.item()) / (16 * iters)


def _check_args(cols, n_servers):
    N = cols[0].shape[0] if cols[0].ndim == 1 else -1
    for name, t, dtype in zip(("arrive", "exec_t", "p95", "outage",
                               "active"), cols,
                              (torch.float64,) * 2 + (torch.bool,) * 3):
        if t.dtype != dtype or t.ndim != 1 or t.shape[0] != N:
            raise ValueError(f"queue_scan takes (N,) {dtype} {name}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in cols}
    if len(devs) != 1:
        raise ValueError(f"queue_scan operands on mixed devices: "
                         f"{sorted(map(str, devs))}")
    if n_servers < 1:
        raise ValueError(f"queue_scan needs n_servers >= 1, got {n_servers}")


def queue_scan(arrive, exec_t, p95, outage, active, n_servers: int,
               thr: float):
    """arrive, exec_t: (N,) float64; p95, outage, active: (N,) bool, all on
    one device; n_servers >= 1; thr: the wait above which a p95-gated
    request hedges. Returns (waits (N,) float64, hedges 0-d int64) on
    that device (see `kernels.ref.queue_scan_ref`)."""
    cols = (arrive, exec_t, p95, outage, active)
    _check_args(cols, n_servers)
    dev = arrive.device
    if dev.type == "cpu":
        return R.queue_scan_ref(*cols, n_servers, thr)
    if dev.type != "cuda":
        raise ValueError(f"queue_scan runs on CUDA or CPU tensors, not "
                         f"{dev}")
    cols = [t.contiguous() for t in cols]
    wait = torch.empty(arrive.shape[0], dtype=torch.float64, device=dev)
    hedges = torch.empty(1, dtype=torch.int64, device=dev)
    free = torch.empty(n_servers, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().queue_scan_fwd(
            *(t.data_ptr() for t in cols), arrive.shape[0], n_servers,
            float(thr), free.data_ptr(), wait.data_ptr(), hedges.data_ptr(),
            stream)
    _build.check(err, "queue_scan")
    queue_scan.launches += 1
    return wait, hedges[0]


queue_scan.launches = 0
