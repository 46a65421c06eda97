"""Plain PyTorch versions of every kernel: what each wrapper runs on a
CPU tensor, and what each CUDA kernel is held against on the card.

Same semantics as the kernels: the finite -1e30 fill for masked
logits, and a query row with no attendable key writes zeros."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


def flash_attention_ref(q, k, v, *, window: int = 0, cap: float = 0.0,
                        scale: float | None = None, causal: bool = True,
                        valid_from=None):
    """q: (B, Hq, T, hd); k, v: (B, KV, S, hd). Positions are implicit
    (q position i == kv position i). valid_from: optional (B,) first
    attendable key index per batch row; query rows with no attendable
    key at all produce zeros. Returns (B, Hq, T, hd) in q.dtype."""
    B, Hq, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = Hq // KV
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    qg = q.reshape(B, KV, rep, T, hd).float() * scale
    logits = torch.einsum("bgrth,bgsh->bgrts", qg, k.float())
    logits = softcap(logits, cap)
    pos_q = torch.arange(T, device=dev)[:, None]
    pos_k = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= pos_k <= pos_q
    if window:
        mask &= pos_k > pos_q - window
    mask = mask[None] if valid_from is None else (
        mask[None] & (pos_k[None] >= valid_from.long()[:, None, None]))
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrts,bgsh->bgrth", p, v.float())
    if valid_from is not None:
        any_valid = mask.any(dim=-1)                               # (B,T)
        out = torch.where(any_valid[:, None, None, :, None], out, 0.0)
    return out.reshape(B, Hq, T, hd).to(q.dtype)


def decode_attention_ref(q, k, v, pos, cache_pos, *, cap: float = 0.0,
                         scale: float | None = None, window: int = 0,
                         valid_from=None):
    """q: (B, Hq, hd); k, v: (B, KV, S, hd); pos: (S,) stored positions
    (-1 = unwritten); cache_pos: current position (int or scalar
    tensor). valid_from: optional (B,) first attendable stored position
    per row (rows with no attendable slot produce zeros). (B, Hq, hd)."""
    B, Hq, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    rep = Hq // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, rep, hd).float() * scale
    logits = torch.einsum("bgrh,bgsh->bgrs", qg, k.float())
    logits = softcap(logits, cap)
    pos = pos.long()
    valid = (pos >= 0) & (pos <= cache_pos)
    if window:
        valid &= pos > cache_pos - window
    valid = valid[None] if valid_from is None else (
        valid[None] & (pos[None] >= valid_from.long()[:, None]))  # (B,S)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bgsh->bgrh", p, v.float())
    if valid_from is not None:
        out = torch.where(valid.any(dim=-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def int8_matmul_ref(x, w_q, w_scale):
    """x: (M, K) float; w_q: (K, N) int8; w_scale: (1, N) or (N,) f32.
    Dequantizes before the product (the kernel scales after it)."""
    w = w_q.float() * w_scale.reshape(1, -1).float()
    return (x.float() @ w).to(x.dtype)


def queue_scan_ref(arrive, exec_t, p95, outage, active, n_servers: int,
                   thr: float):
    """The open-loop queue recurrence, one request at a time in request
    order (the python engine's loop, serving/simulator.py): arrive, exec_t
    (N,) float64; p95, outage, active (N,) bool. Each active request
    takes the first server with the least free time, starts at
    max(arrive, free), waits start - arrive and frees the server at
    start + exec_t; an inactive one waits 0. A hedge counts where the
    request is active, n_servers > 1, and either its p95 gate is set and
    it waits more than thr, or its outage gate is set. Returns the
    (N,) float64 waits and the hedge count (0-d int64) on arrive's
    device. A Python loop over floats (fp64 max, add and subtract, as
    the kernel)."""
    a, e = arrive.tolist(), exec_t.tolist()
    p, o, act = p95.tolist(), outage.tolist(), active.tolist()
    free = [0.0] * n_servers
    wait = [0.0] * len(a)
    hedges = 0
    hedgeable = n_servers > 1
    for i in range(len(a)):
        if not act[i]:
            continue
        s, m = 0, free[0]
        for k in range(1, n_servers):
            if free[k] < m:
                s, m = k, free[k]
        start = m if m > a[i] else a[i]
        w = start - a[i]
        if hedgeable and ((p[i] and w > thr) or o[i]):
            hedges += 1
        free[s] = start + e[i]
        wait[i] = w
    dev = arrive.device
    return (torch.tensor(wait, dtype=torch.float64, device=dev),
            torch.tensor(hedges, dtype=torch.int64, device=dev))


# The per-request outputs of the cluster scan, in the reference's order
# (src/repro/serving/cluster_engine.py:509-524), with their dtypes.
CLUSTER_SCAN_COLUMNS = (
    ("scale1", torch.int32), ("scale2", torch.int32), ("shed", torch.bool),
    ("hedged", torch.bool), ("j1", torch.int32), ("sel1", torch.int32),
    ("place1", torch.bool), ("j2", torch.int32), ("sel2", torch.int32),
    ("place2", torch.bool), ("jw", torch.int32), ("flatw", torch.int32),
    ("qw", torch.float64), ("xw", torch.float64), ("e2ew", torch.float64),
    ("okw", torch.bool))


def cluster_scan_ref(xs, init, const, has_budget: bool):
    """The scan cluster engine's request-axis scan, one request at a time
    (the reference's `step` and `leg`, src/repro/serving/cluster_engine.py:
    381-525, line by line) as a Python loop over floats: every product is
    rounded before it feeds a sum, the quotient by a replica's speed is
    an IEEE division, ties go to the first index.

    xs: the (N,) columns arr, ti, slac, slar, prio, od (float64), has, degr
    (bool), al (int8), sel (N, R) int32 and cdf (N, R, K or 0) float64.
    init: (free (R,) float64, hot (E,) bool, last (E,) float64, hb 0-d
    int64, n_act 0-d int32, up (R,) int32, zp (R,) int32), E = R * K.
    const: mu, sgp, p1mu, xmu, xsgp (E,) float64, sizes (E,) int64, cap,
    speed (R,) float64, kind (R,) int32, u (R, N or 1) float64, ri (R, N
    or 1) int32, z (R, 2N) float64, and the 0-d budget (int64),
    min_active (int32), hedge (bool), shed_factor and headroom (float64).
    Returns (the final carry, as init; {name: (N,) column} of
    CLUSTER_SCAN_COLUMNS, with vict1 and vict2 (N, E) int32, -1 filled,
    when has_budget) on xs["arr"]'s device."""
    inf = float("inf")
    arr, ti = xs["arr"].tolist(), xs["ti"].tolist()
    slac, slar = xs["slac"].tolist(), xs["slar"].tolist()
    has, prio, od = xs["has"].tolist(), xs["prio"].tolist(), xs["od"].tolist()
    degr, al, selx = xs["degr"].tolist(), xs["al"].tolist(), xs["sel"].tolist()
    cdf = xs["cdf"].tolist()
    free, hot, last = (init[0].tolist(), init[1].tolist(),
                       init[2].tolist())
    hb, n_act = int(init[3]), int(init[4])
    up, zp = init[5].tolist(), init[6].tolist()
    c = {k: v.tolist() for k, v in const.items()}
    mu, sgp, p1mu = c["mu"], c["sgp"], c["p1mu"]
    xmu, xsgp = c["xmu"], c["xsgp"]
    sizes, cap, speed, kind = c["sizes"], c["cap"], c["speed"], c["kind"]
    u, ri, z = c["u"], c["ri"], c["z"]
    budget, min_active, hedge = c["budget"], c["min_active"], c["hedge"]
    shed_factor, headroom = c["shed_factor"], c["headroom"]
    N, R = len(arr), len(free)
    E = len(hot)
    K = E // R
    zlast = len(z[0]) - 1

    def leg(i, j, on, vict):
        nonlocal hb
        kj = kind[j]
        if kj == 1:
            uu = u[j][min(up[j], len(u[j]) - 1)]
            sel = sum(1 for v in cdf[i][j] if v <= uu)
        elif kj == 2:
            sel = ri[j][min(up[j], len(ri[j]) - 1)]
        else:
            sel = selx[i][j]
        if on and kj != 0:
            up[j] += 1
        flat = j * K + sel
        need = on and not hot[flat]
        if has_budget and need:
            size = sizes[flat]
            cnt = 0
            while hb + size > budget:
                vals = [last[e] if hot[e] and e != flat else inf
                        for e in range(E)]
                if not any(hot[e] and e != flat for e in range(E)):
                    break
                v = vals.index(min(vals))          # the first argmin
                hot[v] = False
                vict[cnt] = v
                cnt += 1
                hb -= sizes[v]
        if on:
            last[flat] = arr[i]
            hot[flat] = True
        if need:
            hb += sizes[flat]
        xm = xmu[flat]
        needs_z = 1 if need and xm > 0.0 else 0
        zj = z[j]
        zc = zj[min(zp[j], zlast)]
        startup = 0.0
        if need:
            startup = max(xm + xsgp[flat] * zc, 0.0) if xm > 0.0 else xm
        ze = zj[min(zp[j] + needs_z, zlast)]
        if on:
            zp[j] += 1 + needs_z
        exc = max(mu[flat] + sgp[flat] * ze, p1mu[flat]) / speed[j] + startup
        arrive = arr[i] + ti[i]
        start = max(arrive, free[j])
        queue = start - arrive
        if on:
            free[j] = start + exc
        e2e = 2.0 * ti[i] + queue + exc
        return sel, flat, need, queue, exc, e2e

    def first_best(dm):
        # argmax(m & (cm == max(cm))), m = dm == min(dm), cm = where(m,
        # cap, -inf): the first index of the most capacity among the
        # least delays.
        md = min(dm)
        top = max(cap[r] if dm[r] == md else -inf for r in range(R))
        return next((r for r in range(R) if dm[r] == md and cap[r] == top),
                    0)

    rows = []
    victs = ([[[-1] * E for _ in range(N)] for _ in range(2)] if has_budget
             else [[None] * N] * 2)
    for i in range(N):
        a = al[i]
        want = min(max(n_act + (a > 0) - (a < 0), min_active), R)
        do1 = a != 0 and want != n_act
        n1 = want if do1 else n_act
        arrive = arr[i] + ti[i]
        delays = [max(0.0, f - arrive) for f in free]
        md1 = min(delays[:max(n1, 0)], default=inf)
        grow = md1 > headroom * slac[i] and n1 < R
        n2 = n1 + grow
        dmask = [d if r < n2 else inf for r, d in enumerate(delays)]
        md2 = min(dmask)
        thresh = (shed_factor * slac[i]) * (1.0 + prio[i])
        shed = (md2 > thresh and od[i] > 0.0
                and (od[i] <= slac[i] or md2 > 2.0 * thresh))
        j1 = first_best(dmask)
        dmask[j1] = inf
        j2 = first_best(dmask)
        do_hedge = (not shed) and degr[i] and hedge and n2 > 1
        sel1, flat1, place1, q1, x1, t1 = leg(i, j1, not shed, victs[0][i])
        sel2, flat2, place2, q2, x2, t2 = (
            leg(i, j2, True, victs[1][i]) if do_hedge
            else (0, 0, False, 0.0, 0.0, 0.0))
        win2 = do_hedge and t2 < t1
        e2ew = t2 if win2 else t1
        rows.append((
            n1 if do1 else -1, n2 if grow else -1, shed, do_hedge, j1, sel1,
            place1, j2, sel2, place2, j2 if win2 else j1,
            flat2 if win2 else flat1, q2 if win2 else q1,
            x2 if win2 else x1, e2ew, e2ew <= slar[i] if has[i] else True))
        n_act = n2
    out = list(zip(*rows))
    dev = xs["arr"].device
    ys = {name: torch.tensor(col, dtype=dtype, device=dev)
          for (name, dtype), col in zip(CLUSTER_SCAN_COLUMNS, out)}
    if has_budget:
        for k, v in zip(("vict1", "vict2"), victs):
            ys[k] = torch.tensor(v, dtype=torch.int32,
                                 device=dev).reshape(N, E)
    carry = (torch.tensor(free, dtype=torch.float64, device=dev),
             torch.tensor(hot, dtype=torch.bool, device=dev),
             torch.tensor(last, dtype=torch.float64, device=dev),
             torch.tensor(hb, dtype=torch.int64, device=dev),
             torch.tensor(n_act, dtype=torch.int32, device=dev),
             torch.tensor(up, dtype=torch.int32, device=dev),
             torch.tensor(zp, dtype=torch.int32, device=dev))
    return carry, ys
