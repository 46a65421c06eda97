"""The CUDA kernels of the port against their plain versions, on the
card. Marked `gpu`; each test asks the `cuda` fixture for the device,
which skips when there is none (decided at run time, never at import,
so every pytest worker collects the same tests).

Run on a GPU host:  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref as R

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


def test_decode_attention_pins(cuda):
    q = _randn(cuda, (3, 1, 4, 64), torch.float32)
    k = _randn(cuda, (3, 300, 4, 64), torch.float32)
    pos = torch.arange(300, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(3, dtype=torch.int32, device="cuda")
    assert torch.equal(ops.decode_attention(q, k, k, pos, 250, linear=True),
                       ops.decode_attention(q, k, k, pos, 250, zeros,
                                            linear=True))
    vf = torch.tensor([70, 130, 0], dtype=torch.int32, device="cuda")
    assert torch.equal(ops.decode_attention(q, k, k, pos, 250, vf,
                                            linear=True),
                       ops.decode_attention(q, k, k, pos, 250, vf,
                                            linear=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mnk", [(4, 96, 160), (8, 33, 70), (100, 200, 300),
                                 (257, 64, 130)])
def test_int8_matmul_matches_plain(cuda, mnk, dtype):
    M, N, K = mnk
    x = _randn(cuda, (M, K), dtype)
    wq = torch.randint(-127, 128, (K, N), generator=cuda, device="cuda",
                       dtype=torch.int8)
    sc = torch.rand((N,), generator=cuda, device="cuda") * 1e-2
    before = ops.launch_counts()["int8_matmul"]
    out = ops.int8_matmul(x, wq, sc)
    want = R.int8_matmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * float(
        want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= tol
    assert ops.launch_counts()["int8_matmul"] == before + 1
