"""The CUDA kernels of the port against their plain versions, on the
card. Marked `gpu`; each test asks the `cuda` fixture for the device,
which skips when there is none (decided at run time, never at import,
so every pytest worker collects the same tests).

Run on a GPU host:  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import inspect

import pytest
import torch

from repro_torch.kernels import ops, ref as R
from repro_torch.kernels.decode_attention import decode_plan
from repro_torch.kernels.int8_matmul import (int8_matmul as kint8,
                                             prefill_plan, small_m_plan)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _assert_close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, T, Hq, KV, hd, window, cap, valid_from)
    (2, 64, 4, 4, 64, 0, 0.0, None),
    (4, 77, 4, 2, 32, 0, 0.0, [0, 7, 32, 77]),
    (2, 96, 4, 1, 16, 24, 30.0, [3, 40]),
    (1, 40, 2, 2, 20, 0, 50.0, [9]),
    (2, 200, 8, 2, 128, 0, 0.0, [0, 57]),
    (1, 130, 4, 2, 256, 64, 50.0, [5]),
    (2, 70, 4, 2, 256, 0, 0.0, [0, 70]),
    # Every instantiated head dim (32, 64, 128, 256) with GQA, a window,
    # softcap and ragged valid_from, T no multiple of the 64-row q tile.
    (2, 100, 4, 4, 32, 16, 0.0, [0, 33]),
    (2, 129, 8, 2, 64, 32, 50.0, [1, 65]),
    (3, 150, 8, 4, 128, 40, 30.0, [0, 64, 150]),
    (2, 161, 16, 8, 256, 48, 50.0, [0, 97]),
    # Head dims padded up in shared memory (to 64, 128, 256); in bf16
    # the rows of hd 36 and 100 (72 and 200 bytes) are not 16-byte
    # aligned and take element loads.
    (1, 75, 4, 2, 36, 8, 0.0, [3]),
    (2, 90, 6, 3, 100, 0, 20.0, [0, 17]),
    (1, 66, 2, 1, 200, 0, 50.0, [0]),
    # gemma2_9b's heads at a long context.
    (2, 4096, 16, 8, 256, 0, 50.0, [0, 1500]),
])
def test_flash_attention_matches_plain(cuda, case, dtype):
    B, T, Hq, KV, hd, win, cap, vf = case
    q = _randn(cuda, (B, T, Hq, hd), dtype)
    k = _randn(cuda, (B, T, KV, hd), dtype)
    v = _randn(cuda, (B, T, KV, hd), dtype)
    vft = None if vf is None else torch.tensor(vf, dtype=torch.int32,
                                              device="cuda")
    out = ops.flash_attention_btHd(q, k, v, vft, window=win, softcap=cap)
    want = R.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=win, cap=cap,
                                 valid_from=vft).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])
    if vf is not None and vf[-1] >= T:
        assert not out[-1].any()


@pytest.mark.parametrize("dtype, hd", [
    (torch.float32, 20),      # 80-byte rows: 16-byte copies
    (torch.bfloat16, 20),     # 40-byte rows: element loads
    (torch.bfloat16, 64),     # 128-byte rows: 16-byte copies
])
def test_flash_attention_each_variant(cuda, dtype, hd):
    """The launcher takes 16-byte copies only where every row is 16-byte
    aligned; bf16 at hd = 20 (40 bytes a row) takes the element-load
    variant. Each agrees with the plain version."""
    q = _randn(cuda, (2, 90, 4, hd), dtype)
    k = _randn(cuda, (2, 90, 2, hd), dtype)
    v = _randn(cuda, (2, 90, 2, hd), dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    vf = torch.tensor([0, 33], dtype=torch.int32, device="cuda")
    out = ops.flash_attention_btHd(q, k, v, vf, softcap=30.0)
    want = R.flash_attention_ref(qt, kt, vt, cap=30.0,
                                 valid_from=vf).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_deterministic(cuda, hd, dtype):
    """No atomics and no split over keys: two calls give the same bits,
    also with another shape's call between them."""
    q = _randn(cuda, (2, 300, 8, hd), dtype)
    k = _randn(cuda, (2, 300, 2, hd), dtype)
    vf = torch.tensor([0, 41], dtype=torch.int32, device="cuda")
    first = ops.flash_attention_btHd(q, k, k, vf, softcap=50.0)
    ops.flash_attention_btHd(q[:, :77], k[:, :77], k[:, :77])
    assert torch.equal(ops.flash_attention_btHd(q, k, k, vf, softcap=50.0),
                       first)


def test_flash_attention_pins(cuda):
    q = _randn(cuda, (2, 70, 4, 64), torch.float32)
    zeros = torch.zeros(2, dtype=torch.int32, device="cuda")
    assert torch.equal(ops.flash_attention_btHd(q, q, q),
                       ops.flash_attention_btHd(q, q, q, zeros))
    pos = torch.arange(100, 170, dtype=torch.int32, device="cuda")
    got = ops.flash_attention(q, q, q, pos, pos, zeros + 109)
    want = ops.flash_attention_btHd(q, q, q, zeros + 9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_attention_valid_from_zero_pin(cuda, hd, dtype):
    """valid_from = 0 gives the bits of valid_from = None at every head
    dim, with GQA and softcap."""
    q = _randn(cuda, (2, 150, 8, hd), dtype)
    k = _randn(cuda, (2, 150, 4, hd), dtype)
    v = _randn(cuda, (2, 150, 4, hd), dtype)
    zeros = torch.zeros(2, dtype=torch.int32, device="cuda")
    assert torch.equal(ops.flash_attention_btHd(q, k, v, softcap=30.0),
                       ops.flash_attention_btHd(q, k, v, zeros, softcap=30.0))


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_attention_bf16_keeps_p_fp32(cuda, hd):
    """bf16 inputs: P V takes p in fp32, as the reference does (it
    multiplies fp32 p by v cast to fp32), not p rounded to bf16.

    The output's own rounding to bf16 (2^-9 of it) hides a bf16-rounded
    p on random inputs, so the keys come in pairs built to cancel: key
    2i + 1 is key 2i with one element a bf16 step or two larger, and its value
    is minus that of key 2i. An odd query row then attends whole pairs,
    and its output, the sum of (p_2i - p_2i+1) v_2i, is about 2^-11 of
    the terms. The bf16 cast of so small a number is below 1e-5, so the
    output there shows P V as it was before the cast: within the fp32
    tolerance of the fp32-p plain version, where the same plain version
    with p rounded to bf16 misses it by far more than the kernel does."""
    bf = torch.bfloat16
    B, T, H = 2, 128, 4
    q = _randn(cuda, (B, T, H, hd), bf)
    k = _randn(cuda, (B, T // 2, H, hd), bf).repeat_interleave(2, dim=1)
    k[:, 1::2, :, 0] = (k[:, 1::2, :, 0].float() * (1 + 2 ** -7)).to(bf)
    v = _randn(cuda, (B, T // 2, H, hd), bf)
    v = torch.stack([v, -v], 2).reshape(B, T, H, hd)
    out = ops.flash_attention_btHd(q, k, v).transpose(1, 2).float()
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))
    want = R.flash_attention_ref(qt, kt, vt)   # fp32 throughout
    s = qt @ kt.transpose(-1, -2) * hd ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(torch.where(causal, s, R.NEG_INF), -1)
    rounded = (p.to(bf).float() @ vt).to(bf).float()
    torch.cuda.synchronize()
    err = (out - want)[:, :, 1::2].abs().max()
    err_rounded = (rounded - want)[:, :, 1::2].abs().max()
    assert err <= TOL[torch.float32], (err, err_rounded)
    assert err_rounded > 20 * err, (err, err_rounded)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("case", [
    # (B, S, Hq, KV, hd, cache_pos, window, cap, valid_from)
    (2, 200, 4, 4, 64, 150, 0, 0.0, None),
    (4, 130, 8, 2, 32, 100, 0, 30.0, [0, 7, 64, 101]),
    (2, 64, 4, 4, 16, 63, 16, 0.0, [5, 50]),
])
def test_decode_attention_matches_plain(cuda, case, ring, dtype):
    B, S, Hq, KV, hd, cpos, win, cap, vf = case
    q = _randn(cuda, (B, 1, Hq, hd), dtype)
    k = _randn(cuda, (B, S, KV, hd), dtype)
    v = _randn(cuda, (B, S, KV, hd), dtype)
    s = torch.arange(S, device="cuda")
    pos = (s + 17) % (S - 3) if ring else s
    pos = torch.where(pos <= cpos, pos, -1).to(torch.int32)
    vft = None if vf is None else torch.tensor(vf, dtype=torch.int32,
                                              device="cuda")
    out = ops.decode_attention(q, k, v, pos, cpos, vft, window=win,
                               softcap=cap, linear=not ring)
    want = R.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                  v.transpose(1, 2), pos, cpos, cap=cap,
                                  window=win, valid_from=vft)
    torch.cuda.synchronize()
    _assert_close(out[:, 0], want, TOL[dtype])
    if vf is not None and vf[-1] > cpos:
        assert not out[-1].any()


def _decode_case(gen, B, S, Hq, KV, hd, cpos, dtype, ring=False):
    q = _randn(gen, (B, 1, Hq, hd), dtype)
    k = _randn(gen, (B, S, KV, hd), dtype)
    v = _randn(gen, (B, S, KV, hd), dtype)
    s = torch.arange(S, device="cuda")
    pos = (s + 17) % max(S - 3, 1) if ring else s
    return q, k, v, torch.where(pos <= cpos, pos, -1).to(torch.int32)


def _decode_check(q, k, v, pos, cpos, vf, dtype, ring=False, window=0,
                  cap=0.0):
    vft = None if vf is None else torch.tensor(vf, dtype=torch.int32,
                                              device="cuda")
    out = ops.decode_attention(q, k, v, pos, cpos, vft, window=window,
                               softcap=cap, linear=not ring)
    want = R.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                  v.transpose(1, 2), pos, cpos, cap=cap,
                                  window=window, valid_from=vft)
    torch.cuda.synchronize()
    _assert_close(out[:, 0], want, TOL[dtype])
    for row in range(q.shape[0]):   # nothing valid: exact zeros
        if vf is not None and not want[row].any():
            assert not out[row].any()
    return out


def _plan(q, k, v):
    return decode_plan(q[:, 0], k.transpose(1, 2), v.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, S, Hq, KV, hd, cache_pos, window, cap, valid_from, ring): q
    # heads per kv head 1, 2, 8, 10 and 16 at head dims 64, 128 and 256
    # (the reference configs' heads), S no multiple of the chunk, rows
    # with nothing valid (valid_from past cache_pos).
    (2, 1000, 8, 8, 64, 900, 0, 0.0, [0, 333], False),
    (2, 777, 16, 8, 256, 700, 0, 50.0, [3, 500], False),
    (2, 1001, 32, 4, 128, 1000, 0, 0.0, [0, 999], True),
    (2, 515, 10, 1, 256, 400, 128, 30.0, [0, 401], False),
    (2, 643, 64, 4, 128, 600, 0, 0.0, [17, 601], True),
    (3, 300, 16, 1, 64, 299, 64, 0.0, [0, 100, 300], False),
    (2, 200, 20, 2, 256, 150, 0, 10.0, [0, 151], True),
    (2, 333, 16, 8, 128, 332, 0, 0.0, [0, 5], False),
    (1, 4096, 16, 8, 256, 4000, 0, 0.0, [1500], False),
])
def test_decode_attention_reference_heads(cuda, case, dtype):
    B, S, Hq, KV, hd, cpos, win, cap, vf, ring = case
    q, k, v, pos = _decode_case(cuda, B, S, Hq, KV, hd, cpos, dtype, ring)
    _decode_check(q, k, v, pos, cpos, vf, dtype, ring, win, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(8, 8, 64), (32, 4, 128), (16, 8, 256),
                                   (64, 4, 128), (10, 1, 256)])
def test_decode_attention_chunk_edges(cuda, heads, dtype):
    """cache_pos on a chunk's last slot and on the next chunk's first,
    valid_from on chunk starts, at cache_pos and past it; and a ring whose
    whole chunks hold only unwritten slots."""
    Hq, KV, hd = heads
    S = 1024
    q, k, v, pos = _decode_case(cuda, 4, S, Hq, KV, hd, S, dtype)
    ch = _plan(q, k, v)["chunk"]
    assert ch < S // 2
    e = 2 * ch
    for cpos, vf in ((e - 1, [0, ch, e - 1, e]), (e, [ch, e, e + 1, 0])):
        p = torch.where(pos <= cpos, pos, -1).to(torch.int32)
        _decode_check(q, k, v, p, cpos, vf, dtype)
    q, k, v, pos = _decode_case(cuda, 4, S, Hq, KV, hd, 900, dtype, True)
    pos[ch:3 * ch] = -1
    _decode_check(q, k, v, pos, 900, [0, ch, 2 * ch, 3 * ch], dtype, True,
                  window=600)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_every_s(cuda, dtype):
    """Every S up to 70 and some larger, cache_pos at the end: S no
    multiple of the chunk, tiles ragged at both ends."""
    ragged = 0
    for S in list(range(1, 71)) + [127, 129, 255, 257, 1000, 1023, 1025]:
        q, k, v, pos = _decode_case(cuda, 2, S, 8, 2, 64, S - 1, dtype)
        ragged += S % _plan(q, k, v)["chunk"] != 0
        _decode_check(q, k, v, pos, S - 1, [0, S // 3], dtype)
    assert ragged > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_nothing_written(cuda, dtype):
    """No slot written (pos all -1): every row writes exact zeros."""
    q, k, v, pos = _decode_case(cuda, 3, 300, 16, 2, 128, 10, dtype)
    pos[:] = -1
    for ring in (False, True):
        out = ops.decode_attention(q, k, v, pos, 10, linear=not ring)
        torch.cuda.synchronize()
        assert not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(4, 4, 64), (32, 4, 128), (16, 8, 256),
                                   (64, 4, 128), (10, 1, 256)])
def test_decode_attention_pins(cuda, heads, dtype):
    """valid_from = 0 gives the bits of None; the linear skip gives those
    of the full scan; two calls (another shape's call between) the same
    bits."""
    Hq, KV, hd = heads
    q, k, v, pos = _decode_case(cuda, 3, 1000, Hq, KV, hd, 700, dtype)
    zeros = torch.zeros(3, dtype=torch.int32, device="cuda")
    vf = torch.tensor([70, 650, 0], dtype=torch.int32, device="cuda")
    assert torch.equal(ops.decode_attention(q, k, v, pos, 700, linear=True),
                       ops.decode_attention(q, k, v, pos, 700, zeros,
                                            linear=True))
    first = ops.decode_attention(q, k, v, pos, 700, vf, linear=True,
                                 softcap=30.0)
    assert torch.equal(first, ops.decode_attention(q, k, v, pos, 700, vf,
                                                   linear=False,
                                                   softcap=30.0))
    ops.decode_attention(q[:1], k[:1, :50], v[:1, :50], pos[:50], 40)
    assert torch.equal(first, ops.decode_attention(q, k, v, pos, 700, vf,
                                                   linear=True,
                                                   softcap=30.0))


@pytest.mark.parametrize("heads", [(32, 32, 64), (32, 4, 128), (16, 8, 256),
                                   (64, 4, 128), (10, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_ignores_cache_pos(cuda, heads, dtype):
    """The split plan takes q, k and v only (shapes, dtype, strides and
    the K/V pointers' alignment), so no cache_pos or valid_from reaches
    it: it is the same for other tensors of these shapes, before and
    after calls at every cache_pos and valid_from in both layouts. A
    chunk is 4 warp tiles, and a group has at most 16 blocks (one
    cluster) and no more than S has chunks."""
    assert list(inspect.signature(decode_plan).parameters) == ["q", "k",
                                                               "v"]
    Hq, KV, hd = heads
    S = 1024
    q, k, v, pos = _decode_case(cuda, 4, S, Hq, KV, hd, S, dtype)
    plan = _plan(q, k, v)
    for cpos in range(0, S + 64, 37):
        for vf in ([0, 0, 0, 0], [0, cpos // 2, cpos, cpos + 1]):
            for ring in (False, True):
                _decode_check(q, k, v, torch.where(pos <= cpos, pos, -1),
                              cpos, vf, dtype, ring)
    q2, k2, v2, _ = _decode_case(cuda, 4, S, Hq, KV, hd, 0, dtype, True)
    assert _plan(q2, k2, v2) == _plan(q, k, v) == plan
    assert 1 <= plan["splits"] <= min(16, -(-S // plan["chunk"]))
    assert plan["chunk"] == 4 * plan["warp_tile"]
    assert plan["resident_clusters"] >= 1


def test_decode_attention_one_launch(cuda):
    """One kernel launch a call: the counter moves by one."""
    q, k, v, pos = _decode_case(cuda, 2, 500, 16, 2, 128, 400,
                                torch.float32)
    before = ops.launch_counts()["decode_attention"]
    ops.decode_attention(q, k, v, pos, 400, linear=True)
    assert ops.launch_counts()["decode_attention"] == before + 1


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_graph_reads_cache_pos(cuda, dtype, linear):
    """One call captured alone in a CUDA graph, then replayed at several
    positions written to its cache_pos scalar, gives the bits of eager
    calls at those positions: the kernel reads the position when it
    runs, with the linear skip on and off."""
    q, k, v, pos = _decode_case(cuda, 3, 700, 16, 2, 128, 699, dtype)
    vf = torch.tensor([0, 100, 650], dtype=torch.int32, device="cuda")
    cpos = torch.full((), 699, dtype=torch.int32, device="cuda")
    call = lambda c: ops.decode_attention(q, k, v, pos, c, vf, softcap=30.0,
                                          linear=linear)
    call(cpos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(cpos)
    for c in (0, 37, 255, 256, 649, 650, 699):
        cpos.fill_(c)
        graph.replay()
        want = call(c)
        torch.cuda.synchronize()
        assert torch.equal(out, want), c


def _serve_steps(eng, gen, V, steps=34, backfill_at=12):
    """A group at T=40 (ragged), `steps` decode steps with a backfill into
    slot 1 before step backfill_at, then a group at T=24 and 4 decode
    steps: the engine's logits at every step, in order, and what was fed.
    """
    B, out, fed = eng.batch_size, [], []

    def prompts(T):
        p = torch.randint(0, V, (B, T), generator=gen, device="cuda")
        fed.append(p.cpu().numpy().astype("int32"))
        return fed[-1]
    out.append(eng.run_prefill(prompts(40), lengths=[40, 17, 33, 1]))
    for i in range(steps):
        nxt = out[-1].argmax(-1).astype("int32")[:, None]
        if i == backfill_at:
            row = prompts(40)[0].copy()
            row[:20] = 0
            out.append(eng.prefill_row(row, 1, length=20))
            nxt[1, 0] = out[-1].argmax(-1)
        out.append(eng.run_decode(nxt))
    out.append(eng.run_prefill(prompts(24), lengths=[24, 24, 3, 10]))
    for _ in range(4):
        out.append(eng.run_decode(out[-1].argmax(-1).astype("int32")[:, None]))
    return out, fed


def _eager_steps(eng, fed, steps=34, backfill_at=12):
    """What _serve_steps computed, through `models.model` on a fresh
    cache for each group; the backfill's row prefill through `forward`
    on a fresh row cache, merged as the engine merges it."""
    from repro_torch.models.model import (decode_step, forward, init_cache,
                                          prefill)
    from repro_torch.serving.engine import InferenceEngine
    cfg, params, out = eng.cfg, eng.params, []
    i32 = dict(dtype=torch.int32, device="cuda")

    def group(toks, lengths):
        T = toks.shape[1]
        vf = torch.tensor([T - n for n in lengths], **i32)
        lg, cache = prefill(params, torch.tensor(toks, device="cuda"), cfg,
                            eng.max_seq, logits_last_only=True, valid_from=vf)
        out.append(lg[:, 0].cpu().numpy())
        return cache, vf

    def decode(cache, pos, vf, nxt):
        lg, _ = decode_step(params, torch.tensor(nxt, device="cuda"), cache,
                            pos, cfg, valid_from=vf)
        out.append(lg[:, 0].cpu().numpy())
    with torch.no_grad():
        cache, vf = group(fed[0], [40, 17, 33, 1])
        for i in range(steps):
            nxt = out[-1].argmax(-1).astype("int32")[:, None]
            if i == backfill_at:
                row = fed[1][0].copy()
                row[:20] = 0
                pos = 40 + i
                rc = init_cache(cfg, 1, eng.max_seq, device="cuda")
                lg, _ = forward(
                    params, torch.tensor(row[None], device="cuda"), cfg,
                    cache=rc, positions=pos - 40 + torch.arange(40, **i32),
                    logits_last_only=True,
                    valid_from=torch.tensor([pos - 20], **i32))
                out.append(lg[0, 0].cpu().numpy())
                InferenceEngine._merge(cache, rc, 1, pos - 40, 40)
                vf[1] = pos - 20
                nxt[1, 0] = out[-1].argmax(-1)
            decode(cache, 40 + i, vf, nxt)
        cache, vf = group(fed[2], [24, 24, 3, 10])
        for i in range(4):
            decode(cache, 24 + i, vf,
                   out[-1].argmax(-1).astype("int32")[:, None])
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_graphs_match_eager_model(cuda, quant):
    """The engine on the card (decode as one captured graph, prefill as
    one a prompt length, over one persistent cache) gives the bits of
    `models.model` run eagerly on a fresh cache, over 34 decode steps
    with a backfill mid-group and a second group at a shorter T. Each
    replay counts the launches its graph records."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.quant.int8 import quantize_exec_tree
    from repro_torch.serving.engine import InferenceEngine
    cfg = dataclasses.replace(reduced_config("stablelm_1_6b"), d_model=256,
                              d_ff=512, n_layers=2, attn_impl="cuda")
    params = init_params(cfg, 0, device="cuda")
    if quant:
        params = quantize_exec_tree(params)
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=128)
    ops.reset_launch_counts()
    with torch.no_grad():
        got, fed = _serve_steps(eng, cuda, cfg.vocab)
    want = _eager_steps(eng, fed)
    assert len(got) == len(want) == 41
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g == w).all(), i
    st = eng.stats
    assert st.graph_captures == 3          # decode, prefill at 40 and 24
    assert st.graph_replays == 2 + 38 and st.compile_time_s > 0
    per_step = eng._graphs["decode"].launches
    assert per_step["decode_attention"] == cfg.n_layers
    assert per_step["flash_attention"] == 0
    assert per_step["int8_matmul"] == (7 * cfg.n_layers if quant else 0)
    before = ops.launch_counts()
    with torch.no_grad():
        eng.run_decode(fed[2][:, :1])
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: per_step[n] for n in after}


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "grok_1_314b"])
def test_moe_ffn_dense_card_matches_cpu(cuda, arch):
    """moe_ffn_dense on the card against the same function on the CPU, on
    the same weights and (2, 33, d) inputs (reduced config, d 256): the
    output within 2e-5 of max|CPU output|, the aux loss within 2e-5, the
    router's experts equal."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.models import moe as M
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(reduced_config(arch), d_model=256)
    p = {k: v[0] for k, v in
         init_params(cfg, 0, device="cpu")["blocks"][0].items()}
    x = torch.randn((2, 33, 256), generator=torch.Generator().manual_seed(1))
    want, aux = M.moe_ffn_dense(p, x, cfg)
    pc = tree_map(lambda t: t.cuda(), p)
    got, aux_c = M.moe_ffn_dense(pc, x.cuda(), cfg)
    torch.cuda.synchronize()
    assert torch.equal(M.router_topk(pc, x.cuda().reshape(66, 256), cfg)[1]
                       .cpu(), M.router_topk(p, x.reshape(66, 256), cfg)[1])
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=0)
    torch.testing.assert_close(aux_c.cpu(), aux, atol=2e-5, rtol=0)


def test_moe_engine_graphs_match_eager_model(cuda):
    """Reduced qwen3-moe (d 256, 4 experts, top 2) through the engine on
    the card: the prefill and decode graphs capture the MoE block (no
    host read in it) and give the bits of `models.model` run eagerly on
    a fresh cache, over 34 decode steps with a backfill mid-group and a
    second group at a shorter T."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import InferenceEngine
    cfg = dataclasses.replace(reduced_config("qwen3_moe_235b"), d_model=256,
                              attn_impl="cuda")
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cuda"),
                          batch_size=4, max_seq=128)
    assert eng._maskable and eng._backfillable
    with torch.no_grad():
        got, fed = _serve_steps(eng, cuda, cfg.vocab)
    want = _eager_steps(eng, fed)
    assert len(got) == len(want) == 41
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g == w).all(), i
    assert eng.stats.graph_captures == 3
    per_step = eng._graphs["decode"].launches
    assert per_step["decode_attention"] == cfg.n_layers
    assert per_step["int8_matmul"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, vf", [(64, [0, 47, 14, 63]),
                                   (512, [0, 212, 383, 475])])
def test_flash_attention_qwen3_moe_heads(cuda, T, vf, dtype):
    """qwen3-moe-235b's heads (64 q heads on 4 kv heads, hd 128) at the
    moe phase's prefill shapes."""
    q = _randn(cuda, (4, T, 64, 128), dtype)
    k = _randn(cuda, (4, T, 4, 128), dtype)
    v = _randn(cuda, (4, T, 4, 128), dtype)
    vft = torch.tensor(vf, dtype=torch.int32, device="cuda")
    out = ops.flash_attention_btHd(q, k, v, vft)
    want = R.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2),
                                 valid_from=vft).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpos, vf", [(100, [0, 47, 14, 63]),
                                      (528, [0, 212, 383, 475])])
def test_decode_attention_qwen3_moe_heads(cuda, cpos, vf, dtype):
    q, k, v, pos = _decode_case(cuda, 4, 1024, 64, 4, 128, cpos, dtype,
                                False)
    _decode_check(q, k, v, pos, cpos, vf, dtype, False)


def _int8_case(gen, M, K, N, dtype, x_pad=0, w_off=0):
    x = _randn(gen, (M, K + x_pad), dtype)[:, :K]
    wq = torch.randint(-127, 128, (K * N + w_off,), generator=gen,
                       device="cuda", dtype=torch.int8)[w_off:].view(K, N)
    sc = torch.rand((N,), generator=gen, device="cuda") * 1e-2
    return x, wq, sc


def _assert_int8_close(out, want, dtype):
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * float(
        want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (M, N, K, x_pad, w_off): x_pad > 0 reads x as a column slice of a
    # wider tensor (lda = K + x_pad); w_off = 1 puts the weights one byte
    # off a 16-byte boundary (the byte-load path at any N).
    (4, 96, 160, 0, 0),
    (8, 33, 70, 0, 0),          # scalar tail: N % 16 != 0
    (1, 70, 33, 0, 0),          # scalar tail, M = 1
    (1, 2048, 2048, 0, 0),      # decode shape, M = 1
    (2, 2048, 2048, 0, 0),      # decode shape, M = 2 (rounds up to 4)
    (8, 2048, 2048, 0, 0),      # decode shape, M = 8
    (3, 2048, 5632, 0, 0),      # vector path, last K slice shorter
    (4, 5632, 2048, 0, 0),
    (5, 160, 1000, 0, 0),       # vector path plus K tail, M rounds up
    (4, 2048, 2048, 37, 0),     # strided x
    (4, 256, 300, 0, 1),        # unaligned weights
    (100, 200, 300, 0, 0),
    (257, 64, 130, 0, 0),
    (257, 64, 130, 5, 0),       # prefill path, strided x
    (100, 33, 70, 0, 0),        # prefill, ragged M, N, K; N % 16 != 0
    (257, 64, 130, 0, 1),       # prefill, unaligned weights
    (100, 33, 70, 5, 1),        # prefill, strided x and unaligned weights
    (130, 96, 101, 3, 0),       # prefill 16-byte copies, K ends mid-copy
    (300, 160, 1000, 0, 0),     # prefill, K tail past the last stage
])
def test_int8_matmul_matches_plain(cuda, case, dtype):
    M, N, K, x_pad, w_off = case
    x, wq, sc = _int8_case(cuda, M, K, N, dtype, x_pad, w_off)
    before = ops.launch_counts()["int8_matmul"]
    out = ops.int8_matmul(x, wq, sc)
    want = R.int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    _assert_int8_close(out, want, dtype)
    assert ops.launch_counts()["int8_matmul"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, N", [(2048, 2048), (2048, 5632), (5632, 2048)])
@pytest.mark.parametrize("M", [9, 16, 64, 255, 256, 800, 2048])
def test_int8_prefill_full_width(cuda, M, K, N, dtype):
    """The prefill (M > 8) path at the full-width projections of
    stablelm-1.6b, at the M that backfill (T) and prefill (B * T) give."""
    x, wq, sc = _int8_case(cuda, M, K, N, dtype)
    before = kint8.prefill_launches
    out = ops.int8_matmul(x, wq, sc)
    want = R.int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    _assert_int8_close(out, want, dtype)
    assert kint8.prefill_launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case, plan", [
    # (M, N, K, x_pad, w_off) -> the variant the launcher takes
    ((2048, 2048, 2048, 0, 0), {"bm": 128, "bn": 128, "vec": True}),
    ((800, 2048, 2048, 0, 0), {"bm": 128, "bn": 128, "vec": True}),
    ((256, 2048, 2048, 0, 0), {"bm": 64, "bn": 64, "vec": True}),
    ((2048, 2048, 2048, 0, 1), {"bm": 64, "bn": 64, "vec": False}),
    ((256, 64, 130, 5, 0), {"bm": 64, "bn": 64, "vec": False}),
])
def test_int8_prefill_each_variant(cuda, case, plan, dtype):
    """Each prefill variant the launcher can pick, picked and right:
    the 128 x 128 tile where its grid gives a block to at least three
    quarters of the SMs (M = 800: 112 blocks of the H100's 132), the
    64 x 64 tile below that, and the element-load variant for unaligned
    operands."""
    M, N, K, x_pad, w_off = case
    x, wq, sc = _int8_case(cuda, M, K, N, dtype, x_pad, w_off)
    assert prefill_plan(x, wq) == plan
    out = ops.int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    _assert_int8_close(out, R.int8_matmul_ref(x, wq, sc), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_prefill_deterministic(cuda, dtype):
    """No split-K and no atomics on the prefill path: repeated calls at
    the serve phase's prefill M = 256 give the same bits."""
    x, wq, sc = _int8_case(cuda, 256, 5632, 2048, dtype)
    first = ops.int8_matmul(x, wq, sc)
    for _ in range(3):
        ops.int8_matmul(x[:, :2048], wq[:2048].contiguous(), sc)
        assert torch.equal(ops.int8_matmul(x, wq, sc), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_deterministic(cuda, dtype):
    """The split-K reduction adds the K slices in a fixed order: repeated
    calls at a decode shape give the same bits, also with other shapes'
    calls between them."""
    x = _randn(cuda, (4, 5632), dtype)
    wq = torch.randint(-127, 128, (5632, 2048), generator=cuda,
                       device="cuda", dtype=torch.int8)
    sc = torch.rand((2048,), generator=cuda, device="cuda") * 1e-2
    first = ops.int8_matmul(x, wq, sc)
    for _ in range(3):
        ops.int8_matmul(x[:, :2048], wq[:2048].contiguous(), sc)
        assert torch.equal(ops.int8_matmul(x, wq, sc), first)


@pytest.mark.parametrize("N", [33, 2048, 5632])
def test_int8_small_m_plan_covers_k_once(cuda, N):
    """The decode path's split plan, as the launcher works it out on this
    card: the K slices cover every row of K exactly once, none is empty,
    and there are at most 8 of them (one portable cluster)."""
    for K in list(range(1, 300)) + [1000, 2048, 5632, 8191, 100000]:
        p = small_m_plan(N, K)
        assert 1 <= p["splits"] <= 8
        seen = torch.zeros(K, dtype=torch.int64)
        for s in range(p["splits"]):
            lo, hi = s * p["k_split"], min(K, (s + 1) * p["k_split"])
            assert lo < hi
            seen[lo:hi] += 1
        assert bool((seen == 1).all())


def test_int8_small_m_every_k(cuda):
    """The kernel against its plain version at every K up to 300 and a
    few larger ones, so at every slice boundary the plan draws."""
    N = 160
    for K in list(range(1, 301)) + [1000, 2047, 5632]:
        x = _randn(cuda, (4, K), torch.float32)
        wq = torch.randint(-127, 128, (K, N), generator=cuda, device="cuda",
                           dtype=torch.int8)
        sc = torch.rand((N,), generator=cuda, device="cuda") * 1e-2
        out = ops.int8_matmul(x, wq, sc)
        want = R.int8_matmul_ref(x, wq, sc)
        tol = 1e-4 * float(want.abs().max())
        assert float((out - want).abs().max()) <= tol, K


@pytest.mark.parametrize("K, N", [(2048, 2048), (2048, 5632), (5632, 2048)])
def test_int8_small_m_plan_fills_the_card(cuda, K, N):
    """At the decode projections of stablelm-1.6b the grid runs in one
    wave (the card holds every tile's cluster at once) and gives every SM
    a block, as far as the limit of 8 slices a tile allows."""
    p = small_m_plan(N, K)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert p["tiles"] <= p["resident_clusters"]
    assert p["tiles"] * p["splits"] >= min(sms, p["tiles"] * 8)


# -- recurrentgemma-2b's shapes (src/repro/configs/recurrentgemma_2b.py):
# its local layers run 16 q heads (tp_pad_heads) on 1 kv head at hd 256,
# window 2048, softcap 0, no valid_from (a recurrent pattern takes none);
# decode reads a 2048-slot ring (linear=False); d_model 2560, d_ff 7680.

def _ring_pos(S, cpos):
    """Stored positions of an S-slot ring at cache_pos cpos: slot s holds
    the latest position p <= cpos with p % S == s (-1 if none yet)."""
    s = torch.arange(S, device="cuda")
    pos = cpos - (cpos - s) % S
    return torch.where(pos >= 0, pos, -1).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [300, 2040, 2560])
def test_flash_attention_recurrentgemma_heads(cuda, T, dtype):
    q = _randn(cuda, (2, T, 16, 256), dtype)
    k = _randn(cuda, (2, T, 1, 256), dtype)
    v = _randn(cuda, (2, T, 1, 256), dtype)
    out = ops.flash_attention_btHd(q, k, v, window=2048)
    want = R.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2),
                                 window=2048).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpos", [1000, 2047, 2048, 2063, 2567])
def test_decode_attention_recurrentgemma_ring(cuda, cpos, dtype):
    """The local layers' 2048-slot ring, before and across its wrap."""
    q, k, v, _ = _decode_case(cuda, 2, 2048, 16, 1, 256, 0, dtype)
    _decode_check(q, k, v, _ring_pos(2048, cpos), cpos, None, dtype,
                  ring=True, window=2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, N", [(2560, 7680), (7680, 2560), (2560, 4096),
                                  (2560, 256), (4096, 2560)])
@pytest.mark.parametrize("M", [4, 2040])
def test_int8_matmul_recurrentgemma_shapes(cuda, M, K, N, dtype):
    """Every int8 projection of recurrentgemma-2b (w_up / w_gate, w_down
    at K = 7680, wq, wk / wv, wo) at a decode M and a prefill M."""
    x, wq, sc = _int8_case(cuda, M, K, N, dtype)
    out = ops.int8_matmul(x, wq, sc)
    want = R.int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    _assert_int8_close(out, want, dtype)


# The dense architectures as their models run them (src/repro/configs/
# gemma2_9b.py, deepseek_coder_33b.py, chameleon_34b.py): gemma2-9b's
# attention is 16 q heads on 8 kv heads at hd 256 with softcap 50, its
# local layers with window 4096 (decode reads a 4096-slot ring,
# linear=False), its global layers a linear cache of up to 8192 slots;
# deepseek-coder-33b pads 56 q heads to 64 on 8 kv heads at hd 128, the
# heads of chameleon-34b; w_down reaches K = 19200 (deepseek) and 22016
# (chameleon), gemma2's K = 14336, yi-9b's K = 11008.

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, window", [(4200, 4096), (4200, 0),
                                       (1024, 4096)])
def test_flash_attention_gemma2_model_shapes(cuda, T, window, dtype):
    q = _randn(cuda, (2, T, 16, 256), dtype)
    k = _randn(cuda, (2, T, 8, 256), dtype)
    v = _randn(cuda, (2, T, 8, 256), dtype)
    vf = torch.tensor([0, 300], dtype=torch.int32, device="cuda")
    out = ops.flash_attention_btHd(q, k, v, vf, window=window, softcap=50.0)
    want = R.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=window, cap=50.0,
                                 valid_from=vf).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpos", [1030, 4095, 4096, 4210, 8191])
def test_decode_attention_gemma2_ring(cuda, cpos, dtype):
    """The local layers' 4096-slot ring before and after its wrap, with
    softcap 50."""
    q, k, v, _ = _decode_case(cuda, 2, 4096, 16, 8, 256, 0, dtype)
    _decode_check(q, k, v, _ring_pos(4096, cpos), cpos, [0, 0], dtype,
                  ring=True, window=4096, cap=50.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpos", [1030, 4210, 8191])
def test_decode_attention_gemma2_global(cuda, cpos, dtype):
    """The global layers' linear 8192-slot cache with softcap 50."""
    q, k, v, pos = _decode_case(cuda, 2, 8192, 16, 8, 256, cpos, dtype)
    _decode_check(q, k, v, pos, cpos, [0, 700], dtype, cap=50.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, vf", [(64, [0, 47, 14, 63]),
                                   (512, None), (512, [0, 212, 383, 475])])
def test_flash_attention_64_8_128(cuda, T, vf, dtype):
    q = _randn(cuda, (4, T, 64, 128), dtype)
    k = _randn(cuda, (4, T, 8, 128), dtype)
    v = _randn(cuda, (4, T, 8, 128), dtype)
    vft = None if vf is None else torch.tensor(vf, dtype=torch.int32,
                                              device="cuda")
    out = ops.flash_attention_btHd(q, k, v, vft)
    want = R.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2),
                                 valid_from=vft).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cpos, vf, ring", [(100, [0, 47, 14, 63], False),
                                            (520, None, False),
                                            (700, [0, 37, 300, 701], True)])
def test_decode_attention_64_8_128(cuda, cpos, vf, ring, dtype):
    q, k, v, pos = _decode_case(cuda, 4, 1024, 64, 8, 128, cpos, dtype,
                                ring)
    _decode_check(q, k, v, pos, cpos, vf, dtype, ring)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K, N", [(22016, 8192), (19200, 7168),
                                  (14336, 3584), (11008, 4096)])
@pytest.mark.parametrize("M", [4, 2048])
def test_int8_matmul_dense_w_down(cuda, M, K, N, dtype):
    """The dense models' w_down, the int8 path's longest sums, at a decode
    M and a prefill M: within 1e-4 (fp32) of max|ref|."""
    x, wq, sc = _int8_case(cuda, M, K, N, dtype)
    out = ops.int8_matmul(x, wq, sc)
    want = R.int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    _assert_int8_close(out, want, dtype)


@pytest.mark.parametrize("K, N", [(22016, 8192), (19200, 7168)])
def test_int8_prefill_long_k_vs_float64(cuda, K, N):
    """The prefill path's longest sums (chameleon-34b's and
    deepseek-coder-33b's w_down, M = 2048, fp32 x) within 1e-5 of
    max|float64 product|. The tensor cores round each mma's sum toward
    zero: one mma chain over K measured 5.3e-5 at K = 22016, fresh sums
    a 16 rows of K at most 2.9e-6 at every K (PERF.md)."""
    x, wq, sc = _int8_case(cuda, 2048, K, N, torch.float32)
    out = ops.int8_matmul(x, wq, sc)
    exact = x.double() @ (wq.double() * sc.double())
    torch.cuda.synchronize()
    rel = float((out.double() - exact).abs().max() / exact.abs().max())
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "int8_matmul"])
def test_kernel_wrappers_raise_under_autograd(cuda, name):
    """The kernels have no backward: a call that autograd would have to
    differentiate raises on the card too, rather than launch and return
    a result cut off from the graph."""
    def calls(requires_grad):
        def rnd(*shape):
            return torch.randn(shape, generator=cuda, device="cuda") \
                .requires_grad_(requires_grad)
        q, k, v = rnd(2, 64, 4, 64), rnd(2, 64, 2, 64), rnd(2, 64, 2, 64)
        pos = torch.arange(64, device="cuda")
        w = torch.randint(-127, 128, (64, 128), generator=cuda,
                          device="cuda", dtype=torch.int8)
        return {
            "flash_attention": lambda: ops.flash_attention(q, k, v, pos, pos),
            "decode_attention": lambda: ops.decode_attention(
                q[:, :1], k, v, pos.int(),
                torch.tensor(63, dtype=torch.int32, device="cuda")),
            "int8_matmul": lambda: ops.int8_matmul(
                rnd(16, 64), w, torch.rand(128, generator=cuda,
                                           device="cuda")),
        }[name]
    before = ops.launch_counts()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        calls(True)()
    assert ops.launch_counts()[name] == before
    with torch.no_grad():
        out = calls(True)()
    torch.cuda.synchronize()
    assert not out.requires_grad and ops.launch_counts()[name] == before + 1


def test_train_grads_two_full_width_layers_match_float64(cuda):
    """stablelm-1.6b at full width cut to 2 layers: the fp32 loss and
    gradients of a B=8, T=64 train step against the same step in float64
    on the card (each leaf within 1e-4 of its max|float64 grad|)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.params import tree_leaves_sorted, tree_map
    from repro_torch.training.step import make_loss_fn, value_and_grad
    cfg = dataclasses.replace(get_config("stablelm_1_6b"), n_layers=2)
    c64 = cfg.with_runtime(param_dtype="float64", compute_dtype="float64")
    p32 = init_params(cfg, seed=1)
    tokens = torch.randint(0, cfg.vocab, (8, 65), generator=cuda,
                           device="cuda")
    batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    (l32, _), g32 = value_and_grad(make_loss_fn(cfg), p32, batch)
    (l64, _), g64 = value_and_grad(
        make_loss_fn(c64), tree_map(lambda t: t.double(), p32), batch)
    assert abs(float(l32) / float(l64) - 1) < 1e-5
    for a, b in zip(tree_leaves_sorted(g32), tree_leaves_sorted(g64)):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert (a.double() - b).abs().max() <= 1e-4 * b.abs().max()


def test_chunked_attention_captures_without_the_skip(cuda):
    """Inside a CUDA graph capture the chunked attention cannot read its
    early-skip decision back to the host, so it runs every key chunk;
    the replay gives the eager call's bits, which skips the first chunk
    (every row starts at 600, past the first 512 keys)."""
    from repro_torch.models.layers import attention_chunked
    q, k, v = (_randn(cuda, (2, 1100, 4, 64), torch.float32)
               for _ in range(3))
    pos = torch.arange(1100, device="cuda")
    vf = torch.tensor([600, 700], dtype=torch.int32, device="cuda")
    kw = dict(window=0, cap=30.0, scale=0.125, chunk_q=512, chunk_k=512,
              valid_from=vf)
    eager = attention_chunked(q, k, v, pos, pos, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        attention_chunked(q, k, v, pos, pos, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = attention_chunked(q, k, v, pos, pos, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert not out[:, :600].any()


def _queue_cols(n, seed, ties, device):
    """Open-loop queue inputs: arrivals plus uploads, execution times and
    the three gates; with `ties`, bursts at one instant and equal
    execution times, so servers' free times tie."""
    g = torch.Generator().manual_seed(seed)
    a = torch.cumsum(torch.empty(n, dtype=torch.float64).exponential_(
        0.5, generator=g), 0)
    e = torch.empty(n, dtype=torch.float64).log_normal_(2.0, 0.5,
                                                        generator=g)
    if ties:
        a = torch.repeat_interleave(a[:(n + 3) // 4], 4)[:n]
        e = torch.full((n,), 8.0, dtype=torch.float64)
    gates = [torch.rand(n, generator=g) < p for p in (0.5, 0.1, 0.9)]
    return [t.to(device) for t in (a, e, *gates)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_servers", [1, 2, 3, 8, 9, 40, 1600])
@pytest.mark.parametrize("n", [1, 1023, 1024, 5000])
def test_queue_scan_matches_plain(cuda, n, n_servers, ties):
    """The kernel against the plain loop bit for bit, across chunk edges
    (1024 requests a stage), with the free times in shared memory
    (S <= 1536) and in the device buffer (S = 1600)."""
    from repro_torch.kernels.queue_scan import queue_scan
    cols = _queue_cols(n, n_servers, ties, "cuda")
    before = queue_scan.launches
    q, h = queue_scan(*cols, n_servers, 17.5)
    want_q, want_h = R.queue_scan_ref(*(t.cpu() for t in cols), n_servers,
                                      17.5)
    torch.cuda.synchronize()
    assert queue_scan.launches == before + 1
    assert torch.equal(q.cpu(), want_q)
    assert int(h) == int(want_h)


def test_queue_scan_checks_its_operands(cuda):
    from repro_torch.kernels.queue_scan import queue_scan
    cols = _queue_cols(64, 0, False, "cuda")
    with pytest.raises(ValueError, match="n_servers >= 1"):
        queue_scan(*cols, 0, 1.0)
    with pytest.raises(ValueError, match="mixed devices"):
        queue_scan(cols[0].cpu(), *cols[1:], 2, 1.0)
    with pytest.raises(ValueError, match="float64"):
        queue_scan(cols[0].float(), *cols[1:], 2, 1.0)


@pytest.mark.parametrize("detector", ["cusum", "ph"])
@pytest.mark.parametrize("fixed_scale", [None, 20.0])
@pytest.mark.parametrize("L", [12, 30, 80])
def test_scan_program_card_equals_cpu(cuda, L, fixed_scale, detector):
    """The scan engine's column program on the card gives the CPU's bits:
    a controller with a fixed (a device-tensor divisor) or learned scale
    over a mode table with an identity lane, an EWMA and pctl:90 (the top
    layout at L = 12, sorted at 30, rolling at 80) through a lag ring."""
    import numpy as np
    from repro_torch.serving import control, scan_engine as se
    rng = np.random.default_rng(L)
    D = 500
    mean = rng.uniform(40.0, 200.0, D)
    t = rng.lognormal(np.log(mean), 0.3, (L, D))
    t[L // 3:2 * L // 3, ::2] *= 3.0
    valid = np.arange(L)[:, None] < rng.integers(L // 2, L + 1, D)[None, :]
    t = np.where(valid, t, 0.0)
    det = (control.CusumDetector(threshold=4.0, drift=0.5, scale=fixed_scale)
           if detector == "cusum" else
           control.PageHinkleyDetector(threshold=6.0, delta=0.25,
                                       scale=fixed_scale))
    ctrl = control.AdaptiveController(
        modes=("stationary", "cautious", "degraded"), detector=det,
        monitor="ewma:0.2", cooldown=3, start=1)
    desc = se.ctrl_desc_from_controller(
        ctrl, lag=2, table_specs=(None, "ewma:0.3", "pctl:90"))
    outs = [se._program(None, desc, *(torch.from_numpy(a).to(dev) for a in
                                      (t, valid, mean)))
            for dev in ("cuda", "cpu")]
    torch.cuda.synchronize()
    assert outs[0]["switched"].any()
    for k, v in outs[1].items():
        assert torch.equal(outs[0][k].cpu(), v), k


def _chip_smoke():
    """chip_smoke.py as a module (its cluster_scan inputs and checks)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("has_budget", [True, False])
@pytest.mark.parametrize("shape", [(3, 3), (1, 1), (8, 5), (260, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cluster_scan_matches_plain(cuda, shape, has_budget, ties):
    """The kernel against the plain loop bit for bit, every column and
    carry, at chip_smoke's shapes (260 x 5: past its shared-memory state,
    in the carry buffers), across chunk edges (256 requests a stage)."""
    from repro_torch.kernels.cluster_scan import cluster_scan
    cs = _chip_smoke()
    Rn, K = shape
    xs, init, const = cs.cluster_inputs(Rn + 7 * K + ties, Rn, K, 700,
                                        has_budget=has_budget, ties=ties)
    before = cluster_scan.launches
    got = cluster_scan(*cs.cluster_tensors(xs, init, const, "cuda"),
                       has_budget)
    want = R.cluster_scan_ref(*cs.cluster_tensors(xs, init, const, "cpu"),
                              has_budget)
    torch.cuda.synchronize()
    assert cluster_scan.launches == before + 1
    bad, err = cs.cluster_scan_diff(got, want)
    assert not bad and err == 0.0, bad


@pytest.mark.parametrize("n", [1, 255, 256, 257])
def test_cluster_scan_chunk_edges(cuda, n):
    from repro_torch.kernels.cluster_scan import cluster_scan
    cs = _chip_smoke()
    xs, init, const = cs.cluster_inputs(n, 3, 3, n, has_budget=True,
                                        kinds="cnn")
    got = cluster_scan(*cs.cluster_tensors(xs, init, const, "cuda"), True)
    want = R.cluster_scan_ref(*cs.cluster_tensors(xs, init, const, "cpu"),
                              True)
    torch.cuda.synchronize()
    assert cs.cluster_scan_diff(got, want) == ([], 0.0)


def test_cluster_engine_on_card_equals_python(cuda):
    """Cluster(engine="scan") on the card against the python Cluster bit
    for bit on a tenant mix whose run evicts and hedges."""
    from repro_torch.kernels.cluster_scan import cluster_scan
    from repro_torch.serving.cluster import make_tenant_workload
    cs = _chip_smoke()
    wl = make_tenant_workload("consumer_burst", n_requests=2000,
                              rate_hz=40.0, seed=7)
    py = cs.make_cluster("consumer_burst", "python", int(250e6))
    py.run(wl)
    card = cs.make_cluster("consumer_burst", "scan", int(250e6))
    before = cluster_scan.launches
    card.run(wl)
    assert cluster_scan.launches == before + 1
    assert any(r["hedged"] for r in py.metrics.records)
    assert any(e["kind"] == "evict" for e in py.events)
    assert card.events == py.events
    assert card.metrics.records == py.metrics.records
    assert card.n_active == py.n_active
    assert cs.cluster_state(card) == cs.cluster_state(py)


def test_cluster_scan_launch_failure_raises(cuda, monkeypatch):
    """The launcher refuses what the kernel cannot run, and a failed
    launch raises: no plain loop in its place, no launch counted."""
    from repro_torch.kernels import _build, cluster_scan as CS
    stream = torch.cuda.current_stream().cuda_stream
    err = CS._lib().cluster_scan_fwd(CS._C.byref(CS._Args()), stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="cluster_scan"):
        _build.check(err, "cluster_scan")
    cs = _chip_smoke()
    args = cs.cluster_tensors(*cs.cluster_inputs(0, 3, 3, 64,
                                                 has_budget=True), "cuda")

    class Failing:
        @staticmethod
        def cluster_scan_fwd(*a):
            return 1      # cudaErrorInvalidValue

    monkeypatch.setattr(CS, "_lib", lambda: Failing)
    before = CS.cluster_scan.launches
    with pytest.raises(RuntimeError, match="cluster_scan: CUDA launch "
                                           "failed"):
        CS.cluster_scan(*args, True)
    assert CS.cluster_scan.launches == before


# -- the sharded serve path ----------------------------------------------------

def _one_rank_group(backend):
    """A one-rank process group of `backend` over localhost."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def _sharded_engine_run(eng, prompts, toks):
    out = [eng.run_prefill(prompts, lengths=[12, 5, 9, 1])]
    out += [eng.run_decode(t) for t in toks[:3]]
    out.append(eng.prefill_row(prompts[2], 1, length=7))
    out += [eng.run_decode(t) for t in toks[3:]]
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sharded_engine_one_rank_nccl_matches_unsharded(cuda, quant):
    """InferenceEngine(parallel=) on a one-rank NCCL mesh (1, 1), its
    collectives captured in the graphs: every step within 1e-4 of
    max|logit| of the unsharded engine, and bit for bit its own eager
    run (graphs=False)."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.quant.int8 import quantize_exec_tree
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    cfg = dataclasses.replace(reduced_config("yi_9b"), attn_impl="cuda")
    params = init_params(cfg, 0, device="cuda")
    if quant:
        params = quantize_exec_tree(params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (6, 4, 1)).astype(np.int32)
    kw = dict(batch_size=4, max_seq=32, device="cuda")
    want = _sharded_engine_run(InferenceEngine(cfg, params, **kw), prompts,
                               toks)
    _one_rank_group("nccl")
    try:
        par = make_parallel(make_mesh((1, 1), ("data", "model")), "serve")
        shards = shard_params(params, cfg, par)
        eng = InferenceEngine(cfg, shards, parallel=par, **kw)
        got = _sharded_engine_run(eng, prompts, toks)
        eager = _sharded_engine_run(InferenceEngine(
            cfg, shards, parallel=par, graphs=False, **kw), prompts, toks)
        assert eng.stats.graph_replays > 0
    finally:
        dist.destroy_process_group()
    for g, w, e in zip(got, want, eager):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_array_equal(g, e)


def test_sharded_moe_engine_one_rank_nccl_graphs_match_eager(cuda):
    """The sharded MoE (moe_mode ep2d) through InferenceEngine(parallel=)
    on a one-rank NCCL mesh at capacity_factor 1.25, where pairs drop:
    the graphs give the eager run's bits at every step (the combine
    gathers each token's rows and sums them in choice order: no
    atomics)."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    base = reduced_config("qwen3_moe_235b")
    cfg = dataclasses.replace(base, attn_impl="cuda", moe=dataclasses.replace(
        base.moe, capacity_factor=1.25))
    params = init_params(cfg, 0, device="cuda")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (6, 4, 1)).astype(np.int32)
    kw = dict(batch_size=4, max_seq=32, device="cuda")
    _one_rank_group("nccl")
    try:
        par = make_parallel(make_mesh((1, 1), ("data", "model")), "serve",
                            moe_mode="ep2d")
        shards = shard_params(params, cfg, par)
        eng = InferenceEngine(cfg, shards, parallel=par, **kw)
        got = _sharded_engine_run(eng, prompts, toks)
        eager = _sharded_engine_run(InferenceEngine(
            cfg, shards, parallel=par, graphs=False, **kw), prompts, toks)
        assert eng.stats.graph_replays > 0
    finally:
        dist.destroy_process_group()
    for g, e in zip(got, eager, strict=True):
        np.testing.assert_array_equal(g, e)


def test_all_gather_one_rank_returns_its_input(cuda):
    """On a one-rank NCCL mesh all_gather over an axis of size 1 returns
    the same CUDA tensor (no copy of a layer's weights); all_reduce's
    NCCL call works in place on it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import all_gather, all_reduce, make_parallel
    _one_rank_group("nccl")
    try:
        par = make_parallel(make_mesh((1, 1), ("data", "model")), "serve")
        x = torch.randn((8, 16, 4), generator=cuda, device="cuda")
        assert all_gather(x, par, ("data",), 1) is x
        assert all_gather(x, par, "model", 0).data_ptr() == x.data_ptr()
        assert all_reduce(x, par, "model") is x
    finally:
        dist.destroy_process_group()


def test_sharded_engine_refuses_graphs_on_gloo(cuda):
    """gloo collectives cannot be captured: graphs with a gloo mesh on
    the card raise; graphs=False runs."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.sharding import make_parallel
    cfg = dataclasses.replace(reduced_config("stablelm_1_6b"),
                              attn_impl="cuda")
    _one_rank_group("gloo")
    try:
        par = make_parallel(make_mesh((1, 1), ("data", "model")), "serve")
        shards = shard_params(init_params(cfg, 0, device="cuda"), cfg, par)
        kw = dict(batch_size=2, max_seq=16, device="cuda", parallel=par)
        with pytest.raises(ValueError, match="graphs=False"):
            InferenceEngine(cfg, shards, **kw)
        InferenceEngine(cfg, shards, graphs=False, **kw)
    finally:
        dist.destroy_process_group()


class _RankMesh:
    """A mesh's names and shape, and one rank's coordinates (what
    shard_params reads)."""

    def __init__(self, shape, coords):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_on_cuda_feed_the_kernels(cuda, rank):
    """shard_params on the card (model rank `rank` of 2): every shard
    contiguous, and the int8 wrapper takes every projection's column
    (q, k, v, up, gate) and row (o, down) shard with its scales, within
    the int8 tolerance of the plain version; flash and decode take the
    local heads."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.params import shard_params, tree_leaves
    from repro_torch.quant.int8 import quantize_exec_tree
    from repro_torch.sharding import make_parallel
    import dataclasses
    cfg = dataclasses.replace(get_config("stablelm_1_6b"), n_layers=2)
    full = quantize_exec_tree(init_params(cfg, 0, device="cuda"))
    par = make_parallel(_RankMesh({"data": 1, "model": 2},
                                  {"data": 0, "model": rank}), "serve")
    shards = shard_params(full, cfg, par)
    assert all(t.is_contiguous() and t.is_cuda for t in tree_leaves(shards))
    blk = shards["blocks"][0]
    leaves = {k: blk[k] for k in ("wq", "wk", "wv", "wo")}
    leaves.update(blk["mlp"])
    for key, w in leaves.items():
        q, s = w["q"][0], w["scale"][0]
        contracted = 2 if key == "wo" else 1
        K = int(torch.tensor(q.shape[:contracted]).prod())
        w2, s2 = q.reshape(K, -1), s.reshape(-1)
        for M in (4, 64):       # the decode path and the prefill path
            x = torch.randn((M, K), generator=cuda, device="cuda")
            got = ops.int8_matmul(x, w2, s2)
            ref = R.int8_matmul_ref(x, w2, s2)
            torch.testing.assert_close(
                got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    Hl, hd = cfg.n_heads // 2, cfg.head_dim
    assert blk["wq"]["q"].shape[2] == Hl
    q = torch.randn((2, 8, Hl, hd), generator=cuda, device="cuda")
    k = torch.randn((2, 8, Hl, hd), generator=cuda, device="cuda")
    v = torch.randn((2, 8, Hl, hd), generator=cuda, device="cuda")
    pos = torch.arange(8, device="cuda")
    _assert_close(ops.flash_attention(q, k, v, pos, pos),
                  R.flash_attention_ref(*(t.transpose(1, 2) for t in
                                          (q, k, v))).transpose(1, 2),
                  TOL[torch.float32])
    cpos = torch.tensor(7, dtype=torch.int32, device="cuda")
    _assert_close(ops.decode_attention(q[:, :1], k, v, pos, cpos),
                  R.decode_attention_ref(q[:, 0], k.transpose(1, 2),
                                         v.transpose(1, 2), pos, 7)[:, None],
                  TOL[torch.float32])
