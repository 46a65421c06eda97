"""The scan cluster engine's request-axis scan: wrapper of the CUDA kernel
`csrc/cluster_scan.cu`.

The kernel replaces no Pallas kernel: the reference runs the scan as a
`lax.scan` (src/repro/serving/cluster_engine.py:527). One thread runs
the dependent chain (placement, shedding, scaling, the two legs with
the global-LRU eviction loop, first-completion-wins) over the cluster
state, which lives in shared memory up to 256 replicas and 1024
entries and in the final-carry buffers beyond (any R and K), while the
block's other warps stage the next chunk of per-request columns. Bit
for bit the reference: the products that feed sums round on their own.

`cluster_scan` launches the kernel for CUDA tensors (or raises) and runs
the plain version `kernels.ref.cluster_scan_ref` for CPU tensors,
nowhere else. `cluster_scan.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref as R

_C = ctypes

# Operands and their dtypes, in the order of ClusterScanArgs.
XS = (("arr", torch.float64), ("ti", torch.float64),
      ("slac", torch.float64), ("slar", torch.float64),
      ("has", torch.bool), ("prio", torch.float64), ("od", torch.float64),
      ("degr", torch.bool), ("al", torch.int8), ("sel", torch.int32),
      ("cdf", torch.float64))
CONST = (("mu", torch.float64), ("sgp", torch.float64),
         ("p1mu", torch.float64), ("xmu", torch.float64),
         ("xsgp", torch.float64), ("sizes", torch.int64),
         ("cap", torch.float64), ("speed", torch.float64),
         ("kind", torch.int32), ("u", torch.float64), ("ri", torch.int32),
         ("z", torch.float64), ("budget", torch.int64),
         ("min_active", torch.int32), ("hedge", torch.bool),
         ("shed_factor", torch.float64), ("headroom", torch.float64))
CARRY = (("free", torch.float64), ("hot", torch.bool),
         ("last", torch.float64), ("hb", torch.int64),
         ("n_act", torch.int32), ("up", torch.int32), ("zp", torch.int32))


class _Args(_C.Structure):
    _fields_ = ([(n, _C.c_void_p) for n, _ in XS + CONST]
                + [(n + "0", _C.c_void_p) for n, _ in CARRY]
                + [(n + "_out", _C.c_void_p) for n, _ in CARRY]
                + [(n, _C.c_void_p) for n, _ in R.CLUSTER_SCAN_COLUMNS]
                + [("vict1", _C.c_void_p), ("vict2", _C.c_void_p),
                   ("n", _C.c_longlong), ("u_cols", _C.c_longlong),
                   ("ri_cols", _C.c_longlong), ("R", _C.c_int),
                   ("K", _C.c_int), ("has_budget", _C.c_int)])


@functools.cache
def _lib():
    lib = _build.load("cluster_scan")
    lib.cluster_scan_fwd.argtypes = [_C.POINTER(_Args), _C.c_void_p]
    lib.cluster_scan_fwd.restype = _C.c_int
    lib.cluster_scan_args_size.restype = _C.c_int
    if lib.cluster_scan_args_size() != _C.sizeof(_Args):
        raise RuntimeError("cluster_scan: ClusterScanArgs and its ctypes "
                           "mirror differ in size")
    return lib


def _check_args(xs, init, const):
    """(N, R, K) of the operands; raises on a shape, dtype or device that
    the scan does not take."""
    N = xs["arr"].shape[0] if xs["arr"].ndim == 1 else -1
    Rn = init[0].shape[0] if init[0].ndim == 1 else 0
    E = init[1].shape[0] if init[1].ndim == 1 else 0
    if N < 1 or Rn < 1 or E < 1 or E % Rn:
        raise ValueError(f"cluster_scan needs N >= 1 requests and R >= 1 "
                         f"replicas of K >= 1 models, got arr "
                         f"{tuple(xs['arr'].shape)}, free "
                         f"{tuple(init[0].shape)}, hot {tuple(init[1].shape)}")
    K = E // Rn
    cdf_k = xs["cdf"].shape[-1] if xs["cdf"].ndim == 3 else -1
    shapes = dict(
        arr=(N,), ti=(N,), slac=(N,), slar=(N,), has=(N,), prio=(N,),
        od=(N,), degr=(N,), al=(N,), sel=(N, Rn),
        cdf=(N, Rn, cdf_k if cdf_k in (0, K) else K),
        mu=(E,), sgp=(E,), p1mu=(E,), xmu=(E,), xsgp=(E,), sizes=(E,),
        cap=(Rn,), speed=(Rn,), kind=(Rn,),
        u=(Rn, const["u"].shape[-1]), ri=(Rn, const["ri"].shape[-1]),
        z=(Rn, 2 * N), budget=(), min_active=(), hedge=(), shed_factor=(),
        headroom=(), free=(Rn,), hot=(E,), last=(E,), hb=(), n_act=(),
        up=(Rn,), zp=(Rn,))
    named = ([(n, d, xs[n]) for n, d in XS]
             + [(n, d, const[n]) for n, d in CONST]
             + [(n, d, t) for (n, d), t in zip(CARRY, init)])
    for name, dtype, t in named:
        if t.dtype != dtype or tuple(t.shape) != shapes[name]:
            raise ValueError(f"cluster_scan takes {shapes[name]} {dtype} "
                             f"{name}, got {tuple(t.shape)} {t.dtype}")
    for name in ("u", "ri"):
        if const[name].shape[-1] < 1:
            raise ValueError(f"cluster_scan needs at least one {name} "
                             f"column")
    devs = {t.device for _, _, t in named}
    if len(devs) != 1:
        raise ValueError(f"cluster_scan operands on mixed devices: "
                         f"{sorted(map(str, devs))}")
    return N, Rn, K


def cluster_scan(xs: dict, init: tuple, const: dict, has_budget: bool):
    """The scan of the reference's `_compile(R, K, has_budget)` program on
    tensors: xs, init and const as `kernels.ref.cluster_scan_ref` takes
    them (the numpy arrays that scan_cluster_run builds, as tensors of the
    same dtypes), all on one device. Returns (the final carry, {name:
    output column}) on that device: the columns of
    `ref.CLUSTER_SCAN_COLUMNS`, and vict1 / vict2 (N, E) int32 when
    has_budget."""
    N, Rn, K = _check_args(xs, init, const)
    dev = xs["arr"].device
    if dev.type == "cpu":
        return R.cluster_scan_ref(xs, init, const, has_budget)
    if dev.type != "cuda":
        raise ValueError(f"cluster_scan runs on CUDA or CPU tensors, not "
                         f"{dev}")
    xs = {n: xs[n].contiguous() for n, _ in XS}
    const = {n: const[n].contiguous() for n, _ in CONST}
    init = tuple(t.contiguous() for t in init)
    E = Rn * K
    carry = tuple(torch.empty_like(t) for t in init)
    ys = {n: torch.empty(N, dtype=d, device=dev)
          for n, d in R.CLUSTER_SCAN_COLUMNS}
    victs = ([torch.empty((N, E), dtype=torch.int32, device=dev)
              for _ in range(2)] if has_budget else [None, None])
    args = _Args(
        **{n: xs[n].data_ptr() for n, _ in XS},
        **{n: const[n].data_ptr() for n, _ in CONST},
        **{n + "0": t.data_ptr() for (n, _), t in zip(CARRY, init)},
        **{n + "_out": t.data_ptr() for (n, _), t in zip(CARRY, carry)},
        **{n: t.data_ptr() for n, t in ys.items()},
        vict1=None if victs[0] is None else victs[0].data_ptr(),
        vict2=None if victs[1] is None else victs[1].data_ptr(),
        n=N, u_cols=const["u"].shape[1], ri_cols=const["ri"].shape[1],
        R=Rn, K=K, has_budget=int(bool(has_budget)))
    if xs["cdf"].shape[2] == 0:
        args.cdf = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().cluster_scan_fwd(_C.byref(args), stream)
    _build.check(err, "cluster_scan")
    cluster_scan.launches += 1
    if has_budget:
        ys["vict1"], ys["vict2"] = victs
    return carry, ys


cluster_scan.launches = 0
