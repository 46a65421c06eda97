#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build,kernels

Phases (each prints its results, one line each):
  build    card name and power limit, torch version, nvcc build of the
           three kernels from src/repro_torch/csrc
  kernels  every kernel against its plain PyTorch version on the card at
           the serving path's full-width shapes (fp32 and bf16), the
           bit-exact pins, and each kernel's time beside its bound, the
           plain version's time and one PyTorch library call's time
  model    full-width stablelm-1.6b (fp32 and int8) through prefill and
           teacher-forced decode on the "cuda" path against the "naive"
           path with the same weights, and a prefill_row backfill
           against a from-scratch prefill
  serve    the main path: CNNSelectServer over the two full-width
           engines (profiling, then requests under cnnselect), then a
           ServingLoop run with staggered arrivals that backfills freed
           slots; every kernel's launch counter must be > 0 here
  profile  (only when asked for) where a full-width decode step's time
           goes: host wall time against device kernel time from
           torch.profiler, and the kernels that take it

The last two lines are a {"kernels": [...]} JSON object and the result
{"ok": true, "device": {...}}. Any failure raises and exits non-zero
before them. Without a CUDA device, or outside a checkout of the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "model", "serve")
EXTRA_PHASES = ("profile",)

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth, fp32 on the
# CUDA cores (the kernels keep IEEE fp32), bf16 on the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Full-width serving shapes of stablelm-1.6b (configs/stablelm_1_6b.py).
B, H, HD, D, F = 4, 32, 64, 2048, 5632
T_PREFILL, S_CACHE = 512, 1024
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
INT8_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOGIT_TOL = 1e-4

KERNEL_META = {
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98"),
    "decode_attention": dict(
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:87"),
    "int8_matmul": dict(
        source="src/repro_torch/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul.py:40"),
}


def log(*parts):
    print(*parts, flush=True)


class Failed(AssertionError):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


def bench_ms(fn, iters=20, warmup=3):
    """Device time of one call: CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes, flops, dtype):
    """Least time (ms) for the work: bytes over HBM rate or operations
    over the peak of the input type, whichever is larger."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------------------------
# Phase: build
# --------------------------------------------------------------------------

def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.nvcc_path()}, {' '.join(_build.NVCC_FLAGS)})")
    return smi[0]


# --------------------------------------------------------------------------
# Phase: kernels
# --------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(out, ref, tol):
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= tol + tol * ref.float().abs()).all())
    return float(err.max()), ok


def _flash_cases():
    T = T_PREFILL
    yield "plain", dict(T=T, KV=H, vf=None)
    yield "vf mid/edge/full", dict(T=T, KV=H, vf=[0, 37, 64, T])
    yield "window", dict(T=T, KV=H, vf=[0, 37, 64, T], window=128)
    yield "softcap", dict(T=T, KV=H, vf=[0, 37, 64, T], cap=30.0)
    yield "T not a block multiple", dict(T=T - 3, KV=H, vf=[0, 5, 100, 1])
    yield "GQA rep=4", dict(T=T, KV=8, vf=[0, 37, 64, 300])


def _decode_pos(kind, cpos):
    s = torch.arange(S_CACHE, device="cuda")
    if kind == "linear":
        pos = s
    else:   # ring: slot != position
        pos = (s + 17) % (S_CACHE - 3)
    return torch.where(pos <= cpos, pos, -1).to(torch.int32)


def _decode_cases():
    cpos = 700
    for kind in ("linear", "ring"):
        yield f"{kind}", dict(kind=kind, cpos=cpos, KV=H, vf=None)
        yield f"{kind} vf", dict(kind=kind, cpos=cpos, KV=H,
                                 vf=[0, 37, 512, cpos + 1])
    yield "ring window", dict(kind="ring", cpos=cpos, KV=H,
                              vf=[0, 37, 512, 600], window=256)
    yield "linear softcap", dict(kind="linear", cpos=cpos, KV=H,
                                 vf=[0, 37, 512, 600], cap=30.0)
    yield "linear GQA rep=4", dict(kind="linear", cpos=cpos, KV=8,
                                   vf=[0, 37, 512, 600])


def phase_kernels(results):
    from repro_torch.kernels import ops, ref as R
    gen = torch.Generator(device="cuda").manual_seed(0)
    vft = lambda v: None if v is None else torch.tensor(
        v, dtype=torch.int32, device="cuda")

    # -- flash attention ---------------------------------------------------
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, c in _flash_cases():
            T, KV = c["T"], c["KV"]
            q = _randn(gen, (B, T, H, HD), dtype)
            k = _randn(gen, (B, T, KV, HD), dtype)
            v = _randn(gen, (B, T, KV, HD), dtype)
            vf = vft(c["vf"])
            kw = dict(window=c.get("window", 0), softcap=c.get("cap", 0.0))
            out = ops.flash_attention_btHd(q, k, v, vf, **kw)
            ref = R.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=kw["window"], cap=kw["softcap"],
                valid_from=vf).transpose(1, 2)
            err, ok = _close(out, ref, TOL[dtype])
            if dtype == torch.float32:
                worst = max(worst, err)
            log(f"flash {str(dtype)[6:]} {name}: T={T} Hq={H} KV={KV} "
                f"hd={HD} vf={c['vf']} max_abs_err={err:.3e} "
                f"tol={TOL[dtype]} {'ok' if ok else 'FAIL'}")
            require(ok, f"flash {name} {dtype}")
            if c["vf"] is not None and c["vf"][-1] >= T:
                require(not out[-1].any(), "flash fully masked row != 0")
    q = _randn(gen, (B, T_PREFILL, H, HD), torch.float32)
    k = _randn(gen, (B, T_PREFILL, H, HD), torch.float32)
    v = _randn(gen, (B, T_PREFILL, H, HD), torch.float32)
    pin = torch.equal(ops.flash_attention_btHd(q, k, v),
                      ops.flash_attention_btHd(q, k, v, vft([0] * B)))
    log(f"flash pin valid_from=0 bit-identical to None: {pin}")
    require(pin, "flash valid_from=0 pin")

    # -- decode attention --------------------------------------------------
    dworst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, c in _decode_cases():
            KV, cpos = c["KV"], c["cpos"]
            q = _randn(gen, (B, 1, H, HD), dtype)
            k = _randn(gen, (B, S_CACHE, KV, HD), dtype)
            v = _randn(gen, (B, S_CACHE, KV, HD), dtype)
            pos = _decode_pos(c["kind"], cpos)
            vf = vft(c["vf"])
            kw = dict(window=c.get("window", 0), softcap=c.get("cap", 0.0))
            out = ops.decode_attention(q, k, v, pos, cpos, vf,
                                       linear=c["kind"] == "linear", **kw)
            ref = R.decode_attention_ref(
                q[:, 0], k.transpose(1, 2), v.transpose(1, 2), pos, cpos,
                cap=kw["softcap"], window=kw["window"], valid_from=vf)
            err, ok = _close(out[:, 0], ref, TOL[dtype])
            if dtype == torch.float32:
                dworst = max(dworst, err)
            log(f"decode {str(dtype)[6:]} {name}: S={S_CACHE} Hq={H} "
                f"KV={KV} hd={HD} cache_pos={cpos} vf={c['vf']} "
                f"max_abs_err={err:.3e} tol={TOL[dtype]} "
                f"{'ok' if ok else 'FAIL'}")
            require(ok, f"decode {name} {dtype}")
            if c["vf"] is not None and c["vf"][-1] > cpos:
                require(not out[-1].any(), "decode fully masked row != 0")
    q = _randn(gen, (B, 1, H, HD), torch.float32)
    k = _randn(gen, (B, S_CACHE, H, HD), torch.float32)
    v = _randn(gen, (B, S_CACHE, H, HD), torch.float32)
    pos = _decode_pos("linear", 700)
    pin0 = torch.equal(ops.decode_attention(q, k, v, pos, 700, linear=True),
                       ops.decode_attention(q, k, v, pos, 700, vft([0] * B),
                                            linear=True))
    vf = vft([33, 300, 0, 650])
    pin1 = torch.equal(ops.decode_attention(q, k, v, pos, 700, vf,
                                            linear=True),
                       ops.decode_attention(q, k, v, pos, 700, vf,
                                            linear=False))
    log(f"decode pin valid_from=0 bit-identical to None: {pin0}")
    log(f"decode pin linear tile skip bit-identical to full scan: {pin1}")
    require(pin0 and pin1, "decode pins")

    # -- int8 matmul -------------------------------------------------------
    iworst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for M in (B, B * T_PREFILL):
            for K, N in ((D, D), (D, F), (F, D)):
                x = _randn(gen, (M, K), dtype)
                wq = torch.randint(-127, 128, (K, N), generator=gen,
                                   device="cuda", dtype=torch.int8)
                sc = torch.rand((N,), generator=gen, device="cuda") * 1e-3
                out = ops.int8_matmul(x, wq, sc)
                ref = R.int8_matmul_ref(x, wq, sc)
                err = float((out.float() - ref.float()).abs().max())
                scale_ = max(1.0, float(ref.float().abs().max()))
                ok = err <= INT8_TOL[dtype] * scale_
                if dtype == torch.float32:
                    iworst = max(iworst, err / scale_)
                log(f"int8 {str(dtype)[6:]} M={M} K={K} N={N}: "
                    f"max_abs_err={err:.3e} max|ref|={scale_:.3e} "
                    f"tol={INT8_TOL[dtype]}*max|ref| "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"int8 M={M} K={K} N={N} {dtype}")

    # -- times at the main path's shapes (fp32, as the model runs) ---------
    f32 = torch.float32
    lens = [T_PREFILL, 300, 129, 37]      # ragged left-padded prefill
    vf = vft([T_PREFILL - n for n in lens])
    q = _randn(gen, (B, T_PREFILL, H, HD), f32)
    k = _randn(gen, (B, T_PREFILL, H, HD), f32)
    v = _randn(gen, (B, T_PREFILL, H, HD), f32)
    pairs = sum(sum(max(0, i - (T_PREFILL - n) + 1) for i in range(T_PREFILL))
                for n in lens)
    nbytes = 4 * q.numel() * 4 + B * 4
    tb, by = bound(nbytes, 4 * HD * H * pairs, f32)
    pos_q = torch.arange(T_PREFILL, device="cuda")
    bool_mask = ((pos_q[None, :] <= pos_q[:, None])[None]
                 & (pos_q[None, None, :] >= vf[:, None, None]))[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    results["flash_attention"] = dict(
        max_abs_err=worst, pins={"valid_from_zero_bit_identical": pin},
        ms=bench_ms(lambda: ops.flash_attention_btHd(q, k, v, vf)),
        plain_ms=bench_ms(lambda: R.flash_attention_ref(qt, kt, vt,
                                                        valid_from=vf)),
        bound_ms=tb, bound_by=by,
        library_ms=bench_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qt, kt, vt, attn_mask=bool_mask)),
        shape=f"B={B} T=S={T_PREFILL} Hq=KV={H} hd={HD} fp32 "
              f"valid_from={[T_PREFILL - n for n in lens]}")

    cpos = T_PREFILL + 16
    q = _randn(gen, (B, 1, H, HD), f32)
    k = _randn(gen, (B, S_CACHE, H, HD), f32)
    v = _randn(gen, (B, S_CACHE, H, HD), f32)
    pos = _decode_pos("linear", cpos)
    n_valid = sum(cpos + 1 - (T_PREFILL - n) for n in lens)
    nbytes = n_valid * H * HD * 4 * 2 + 2 * q.numel() * 4 + S_CACHE * 4
    tb, by = bound(nbytes, 4 * HD * H * n_valid, f32)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    dmask = ((pos >= 0) & (pos <= cpos))[None, :] & (pos[None, :]
                                                     >= vf[:, None])
    results["decode_attention"] = dict(
        max_abs_err=dworst,
        pins={"valid_from_zero_bit_identical": pin0,
              "linear_skip_bit_identical_to_full_scan": pin1},
        ms=bench_ms(lambda: ops.decode_attention(q, k, v, pos, cpos, vf,
                                                 linear=True)),
        plain_ms=bench_ms(lambda: R.decode_attention_ref(
            q[:, 0], kt, vt, pos, cpos, valid_from=vf)),
        bound_ms=tb, bound_by=by,
        library_ms=bench_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                q.transpose(1, 2), kt, vt,
                                attn_mask=dmask[:, None, None, :])),
        shape=f"B={B} S={S_CACHE} cache_pos={cpos} Hq=KV={H} hd={HD} fp32 "
              f"linear")

    rows = {}
    for M in (B, B * T_PREFILL):
        for K, N in ((D, D), (D, F), (F, D)):
            x = _randn(gen, (M, K), f32)
            wq = torch.randint(-127, 128, (K, N), generator=gen,
                               device="cuda", dtype=torch.int8)
            sc = torch.rand((N,), generator=gen, device="cuda") * 1e-3
            wd = wq.float() * sc
            tb, by = bound(M * K * 4 + K * N + N * 4 + M * N * 4,
                           2 * M * K * N, f32)
            r = dict(ms=bench_ms(lambda: ops.int8_matmul(x, wq, sc)),
                     plain_ms=bench_ms(lambda: R.int8_matmul_ref(x, wq, sc)),
                     bound_ms=tb, bound_by=by,
                     library_ms=bench_ms(lambda: torch.matmul(x, wd)))
            rows[(M, K, N)] = r
            log(f"time int8_matmul M={M} K={K} N={N} fp32: "
                f"{json.dumps(r)}")
    results["int8_matmul"] = dict(
        rows[(B, D, F)], max_abs_err=iworst, pins={},
        shape=f"M={B} K={D} N={F} fp32 (decode w_up); max_abs_err is "
              f"relative to max|ref|; other shapes on the lines above")
    for name in ("flash_attention", "decode_attention"):
        log(f"time {name}: {json.dumps(results[name])}")


# --------------------------------------------------------------------------
# Phase: model
# --------------------------------------------------------------------------

def _full_width(attn_impl):
    from repro_torch.configs import get_config
    return get_config("stablelm_1_6b", attn_impl=attn_impl)


def _build_params():
    from repro_torch.models import init_params
    from repro_torch.quant.int8 import quantize_exec_tree, \
        tree_bytes_quantized
    t0 = time.perf_counter()
    p32 = init_params(_full_width("cuda"), seed=0, device="cuda")
    p8 = quantize_exec_tree(p32)
    torch.cuda.synchronize()
    log(f"params: fp32 {tree_bytes_quantized(p32) / 1e9:.3f} GB, int8 "
        f"{tree_bytes_quantized(p8) / 1e9:.3f} GB (embeddings and norms "
        f"shared) in {time.perf_counter() - t0:.1f} s")
    return p32, p8


def phase_model(p32, p8):
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.engine import InferenceEngine
    rng = np.random.default_rng(0)
    V = _full_width("cuda").vocab
    lens = np.array([T_PREFILL, 300, 129, 37])
    toks = torch.as_tensor(rng.integers(0, V, (B, T_PREFILL)),
                           dtype=torch.int32, device="cuda")
    vf = torch.as_tensor(T_PREFILL - lens, dtype=torch.int32, device="cuda")
    forced = rng.integers(0, V, (16, B, 1))
    for label, params in (("fp32", p32), ("int8", p8)):
        runs = {}
        for impl in ("cuda", "naive"):
            cfg = _full_width(impl)
            with torch.no_grad():
                lg, cache = prefill(params, toks, cfg, S_CACHE,
                                    logits_last_only=True, valid_from=vf)
                steps = [lg[:, 0]]
                for s in range(16):
                    tok = torch.as_tensor(forced[s], dtype=torch.int32,
                                          device="cuda")
                    lg, cache = decode_step(params, tok, cache,
                                            T_PREFILL + s, cfg,
                                            valid_from=vf)
                    steps.append(lg[:, 0])
            runs[impl] = torch.stack(steps)
            del cache
        a, b = runs["cuda"], runs["naive"]
        require(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
        worst = 0.0
        for s in range(a.shape[0]):
            rel = float((a[s] - b[s]).abs().max() / b[s].abs().max())
            worst = max(worst, rel)
            require(rel <= LOGIT_TOL, f"{label} step {s}: {rel:.2e}")
        log(f"model {label}: stablelm-1.6b full width, prefill B={B} "
            f"T={T_PREFILL} lengths={lens.tolist()} + 16 decode steps, cuda "
            f"vs naive: max |dlogit|/max|logit| = {worst:.3e} over 17 steps "
            f"(tol {LOGIT_TOL}); max|logit|={float(b.abs().max()):.2f}")

    # prefill_row backfill against a from-scratch prefill (fp32, cuda).
    cfg = _full_width("cuda")
    P = 256
    eng = InferenceEngine(cfg, p32, batch_size=B, max_seq=S_CACHE)
    ref = InferenceEngine(cfg, p32, batch_size=B, max_seq=S_CACHE)
    prompts = rng.integers(0, V, (B, P)).astype(np.int32)
    p_new = rng.integers(0, V, 100).astype(np.int32)
    with torch.no_grad():
        logits = eng.run_prefill(prompts)
        hist = prompts.copy()
        for _ in range(2):
            nxt = logits.argmax(-1).astype(np.int32)
            hist = np.concatenate([hist, nxt[:, None]], axis=1)
            logits = eng.run_decode(nxt[:, None])
        joined = np.zeros(P, np.int32)
        joined[P - len(p_new):] = p_new
        lj = eng.prefill_row(joined, 0, length=len(p_new))
        row0 = np.zeros(P + 2, np.int32)
        row0[P + 2 - len(p_new):] = p_new
        full = np.concatenate([row0[None], hist[1:]], axis=0)
        lr = ref.run_prefill(full, lengths=[len(p_new)] + [P + 2] * (B - 1))
        nxt = np.concatenate([[lj.argmax(-1)], logits[1:].argmax(-1)])
        nxt = nxt.astype(np.int32)[:, None]
        d1, d2 = eng.run_decode(nxt), ref.run_decode(nxt)
    rel = max(np.abs(lj - lr[0]).max() / np.abs(lr[0]).max(),
              np.abs(logits[1:] - lr[1:]).max() / np.abs(lr[1:]).max(),
              np.abs(d1 - d2).max() / np.abs(d2).max())
    log(f"model backfill: prefill_row (100 real tokens into slot 0 at "
        f"cache_pos {P + 2}) vs from-scratch prefill, then one decode: "
        f"max rel dlogit = {rel:.3e} (tol {LOGIT_TOL})")
    require(rel <= LOGIT_TOL and eng.stats.backfill_calls == 1,
            "backfill vs from-scratch prefill")
    del eng, ref
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Phase: serve (the main path)
# --------------------------------------------------------------------------

def phase_serve(p32, p8):
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import Request
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.loop import ServingLoop
    from repro_torch.serving.server import CNNSelectServer, ServedModel

    cfg = _full_width("cuda")
    engines = {"stablelm_fp32": InferenceEngine(cfg, p32, batch_size=B,
                                                max_seq=S_CACHE),
               "stablelm_int8": InferenceEngine(cfg, p8, batch_size=B,
                                                max_seq=S_CACHE)}
    # Offline task scores of the two candidates (set here, as the
    # launcher sets its tiers): int8 pays a small accuracy penalty.
    acc = {"stablelm_fp32": 0.74, "stablelm_int8": 0.73}
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    with torch.no_grad():
        srv = CNNSelectServer(
            [ServedModel(name=n, engine=e, accuracy=acc[n],
                         size_bytes=e.resident_bytes)
             for n, e in engines.items()],
            t_threshold=30.0, policy="cnnselect", n_tokens=8)
        srv.profile_models(prompt_len=64, reps=3)
        profs = srv.current_profiles()
        for p in profs:
            log(f"profile {p.name}: mu={p.mu:.2f} ms sigma={p.sigma:.2f} "
                f"acc={p.accuracy} size={p.size_bytes}")
        mus = sorted(p.mu for p in profs)
        rng = np.random.default_rng(1)
        for i in range(8):
            # Alternate a budget between the two candidates' means and a
            # generous one, so the selection has a real choice to make.
            sla = (mus[0] + mus[1]) / 2 + 40.0 if i % 2 else mus[1] * 3
            req = Request(arrival=0.0, rid=i,
                          prompt=rng.integers(0, cfg.vocab, 64)
                          .astype(np.int32),
                          t_input_ms=float(rng.uniform(5.0, 15.0)))
            rec = srv.handle(req, t_sla=sla)
            require(len(rec["tokens"]) == 8 and rec["e2e_ms"] > 0,
                    f"server request {i}")
            log(f"server req {i}: sla={sla:.1f} {json.dumps(rec)}")
        log(f"server summary: {json.dumps(srv.metrics.summary())}")

        loop = ServingLoop(engines, profiles=profs, t_threshold=30.0,
                           policy="cnnselect")
        reqs = []
        for i in range(10):
            n = int(rng.integers(16, 200))
            reqs.append(Request(
                arrival=0.0 if i < B else float(i), rid=100 + i,
                prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new_tokens=int(2 + i % 5), sla_ms=1e5,
                t_input_ms=float(rng.uniform(5.0, 15.0))))
        m = loop.run(reqs)
    torch.cuda.synchronize()
    for r in m.records:
        log(f"loop record: {json.dumps(r, default=str)}")
    s = m.summary()
    log(f"loop summary: {json.dumps(s)}")
    backfills = {n: e.stats.backfill_calls for n, e in engines.items()}
    log(f"loop backfills: {backfills}")
    require(s["served"] == len(reqs), "loop served every request")
    for b in loop.batchers.values():
        require(all(len(r.tokens) == r.max_new_tokens for r in b.done),
                "loop tokens per request")
    require(sum(backfills.values()) > 0, "loop backfilled a freed slot")
    counts = ops.launch_counts()
    log(f"serve launches: {json.dumps(counts)} in "
        f"{time.perf_counter() - t_start:.1f} s")
    for name, n in counts.items():
        require(n > 0, f"{name} launched on the main path")
    return counts


# --------------------------------------------------------------------------
# Phase: profile (not in the default run)
# --------------------------------------------------------------------------

def phase_profile(p32, p8):
    """Wall time of a full-width decode step (B=4, context 64) against
    the device time its kernels take, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import InferenceEngine
    cfg = _full_width("cuda")
    rng = np.random.default_rng(2)
    for label, params in (("fp32", p32), ("int8", p8)):
        eng = InferenceEngine(cfg, params, batch_size=B, max_seq=S_CACHE)
        steps = 8
        with torch.no_grad():
            logits = eng.run_prefill(rng.integers(0, cfg.vocab, (B, 64))
                                     .astype(np.int32))
            nxt = logits.argmax(-1).astype(np.int32)[:, None]
            for _ in range(2):
                eng.run_decode(nxt)
            torch.cuda.synchronize()
            # Wall and device time come from the same (profiled) steps.
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.run_decode(nxt)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / steps
        # Kernel rows only: an operator row's device time repeats that of
        # the kernels it launched.
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        require(ev, "profiler recorded no device kernels")
        dev = sum(e.self_device_time_total for e in ev) / 1e3 / steps
        n_k = sum(e.count for e in ev) / steps
        log(f"profile {label} decode step: wall {wall:.3f} ms, device "
            f"kernels {dev:.3f} ms ({n_k:.0f} launches), device idle "
            f"share {1 - dev / wall:.3f}")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            ms = e.self_device_time_total / 1e3 / steps
            log(f"profile {label}   {ms:8.3f} ms/step  "
                f"x{e.count / steps:5.0f}  {e.key[:90]}")
        del eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s"
                    % ", ".join(PHASES + EXTRA_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False); this script runs only on the GPU")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != ROOT:
        sys.exit(f"chip_smoke: repro_torch from {repro_torch.__file__}, not "
                 f"from this checkout ({ROOT})")

    t0 = time.perf_counter()
    card = phase_build()
    results = {}
    if "kernels" in phases:
        phase_kernels(results)
    counts = None
    if {"model", "serve", "profile"} & set(phases):
        p32, p8 = _build_params()
        if "model" in phases:
            phase_model(p32, p8)
        if "serve" in phases:
            counts = phase_serve(p32, p8)
        if "profile" in phases:
            phase_profile(p32, p8)
    log(f"card: {card}; wall {time.perf_counter() - t0:.1f} s")
    if results:
        kernels = []
        for name, meta in KERNEL_META.items():
            r = results[name]
            kernels.append(dict(
                name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"],
                launches=None if counts is None else counts[name],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                pins=r["pins"],
                shape=r["shape"]))
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
