"""The port's chunked attention (`repro_torch.models.layers.
attention_chunked`, attn_impl "chunked") against the reference's
`attention_chunked` (its "jax_chunked") on the CPU, and "auto"'s choice
between naive and chunked attention on both sides of Tq*Tk = 4096².

Inputs are drawn from a numpy seed and handed to both sides. Tolerance:
2e-5 of max|reference| in fp32, 2e-2 in bf16 (tests/test_kernels.py's
limits)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro_torch.configs import reduced_config
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, T, Hq, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, h, hd)).astype(np.float32)
               for h in (Hq, KV, KV))
    return q, k, v


def _both(q, k, v, pos, dtype, vf=None, *, window=0, cap=0.0, chunk=8,
          nan_v_below=None):
    """(port, reference) attention_chunked outputs as fp32 numpy.
    nan_v_below: v rows at positions below it set to NaN on both sides
    (a chunk that is computed there turns its rows' outputs to NaN)."""
    if nan_v_below is not None:
        v = v.copy()
        v[:, :nan_v_below] = np.nan
    scale = q.shape[-1] ** -0.5
    kw = dict(window=window, cap=cap, scale=scale, chunk_q=chunk,
              chunk_k=chunk)
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    want = JL.attention_chunked(
        *jx, jnp.asarray(pos, jnp.int32), jnp.asarray(pos, jnp.int32),
        valid_from=None if vf is None else jnp.asarray(vf, jnp.int32), **kw)
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    tpos = torch.from_numpy(np.asarray(pos, np.int32))
    got = TL.attention_chunked(
        *tx, tpos, tpos,
        valid_from=None if vf is None else torch.tensor(vf, dtype=torch.int32),
        **kw)
    return (got.float().numpy(),
            np.asarray(want.astype(jnp.float32)))


def _close(got, want, dtype):
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (B, T, Hq, KV, hd, window, cap, valid_from, chunk)
    (2, 37, 4, 2, 16, 0, 0.0, None, 8),          # padded q and k, GQA
    (2, 40, 4, 4, 16, 0, 0.0, None, 16),         # no padding
    (1, 45, 2, 1, 8, 8, 0.0, None, 8),           # window
    (2, 33, 4, 2, 16, 0, 30.0, None, 8),         # softcap
    (2, 50, 4, 2, 16, 12, 50.0, [0, 21], 8),     # all together
    (3, 29, 2, 2, 8, 0, 0.0, [3, 29, 40], 8),    # masked rows -> zeros
    (1, 7, 2, 1, 8, 0, 0.0, None, 16),           # one chunk smaller than T
])
def test_chunked_matches_reference(case, dtype):
    B, T, Hq, KV, hd, win, cap, vf, chunk = case
    q, k, v = _inputs(0, B, T, Hq, KV, hd, dtype)
    got, want = _both(q, k, v, np.arange(T), dtype, vf, window=win, cap=cap,
                      chunk=chunk)
    _close(got, want, dtype)
    if vf is not None:
        for b, f in enumerate(vf):
            if f >= T:
                assert not got[b].any() and not want[b].any()


def test_chunked_early_skip_fires():
    """Every row starts at 17 or later: key chunks 0 and 1 (positions
    0-15) lie below every row's valid_from, and both sides skip them,
    so the NaNs placed in their v never reach an output."""
    q, k, v = _inputs(1, 2, 44, 4, 2, 16, "float32")
    got, want = _both(q, k, v, np.arange(44), "float32", [17, 30],
                      window=0, cap=20.0, chunk=8, nan_v_below=16)
    _close(got, want, "float32")
    # Without the skip (valid_from 0 on a row) the NaNs reach the output.
    got, _ = _both(q, k, v, np.arange(44), "float32", [0, 30],
                   window=0, cap=20.0, chunk=8, nan_v_below=16)
    assert np.isnan(got).any()


def test_chunked_equals_naive_and_decode_is_naive():
    """Chunked attention against the port's naive attention on one input,
    and a one-token query takes the naive path under "chunked", as in
    the reference's `_impl_chunked`."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(2, 2, 40, 4, 2, 16, "float32"))
    pos = torch.arange(40)
    vf = torch.tensor([0, 9], dtype=torch.int32)
    kw = dict(window=6, cap=30.0, scale=0.25, valid_from=vf)
    naive = TL.attention_naive(q, k, v, pos, pos, **kw)
    chunked = TL.attention_chunked(q, k, v, pos, pos, chunk_q=16,
                                   chunk_k=8, **kw)
    torch.testing.assert_close(chunked, naive, rtol=0, atol=2e-5)
    cfg = reduced_config("stablelm_1_6b", attn_impl="chunked")
    one = TL.attention(q[:, -1:], k, v, pos[-1:], pos, cfg, window=6,
                       valid_from=vf)
    want = TL.attention_naive(q[:, -1:], k, v, pos[-1:], pos,
                              window=6, cap=0.0, scale=cfg.head_dim ** -0.5,
                              valid_from=vf)
    assert torch.equal(one, want)


@pytest.mark.parametrize("T", [4096, 4104])
def test_auto_takes_the_reference_branch(T, monkeypatch):
    """B=1, one head, hd 8: at T = 4096 (Tq*Tk = 4096²) both sides take
    naive attention, at T = 4104 both take chunked, and the outputs
    agree."""
    taken = {"port": [], "ref": []}

    def spy(side, table, name):
        fn = table[name]

        def wrapped(*a, **kw):
            taken[side].append(name)
            return fn(*a, **kw)
        monkeypatch.setitem(table, name, wrapped)

    for name in ("naive", "jax_chunked"):
        spy("ref", JL.ATTN_IMPLS, name)
    for name in ("naive", "chunked"):
        spy("port", TL.ATTN_IMPLS, name)
    jcfg = dataclasses.replace(jax_reduced_config("stablelm_1_6b"),
                               head_dim=8, attn_chunk=512)
    tcfg = dataclasses.replace(reduced_config("stablelm_1_6b"), head_dim=8,
                               attn_chunk=512)
    assert jcfg.attn_impl == tcfg.attn_impl == "auto"
    q, k, v = _inputs(3, 1, T, 1, 1, 8, "float32")
    pos = np.arange(T, dtype=np.int32)
    want = JL.attention(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.asarray(pos), jnp.asarray(pos), jcfg, window=0)
    tpos = torch.from_numpy(pos)
    got = TL.attention(*(torch.from_numpy(a) for a in (q, k, v)), tpos, tpos,
                       tcfg, window=0)
    branch = "naive" if T * T <= 4096 * 4096 else "chunked"
    assert taken["port"] == [branch]
    assert taken["ref"] == ["naive" if branch == "naive" else "jax_chunked"]
    _close(got.numpy(), np.asarray(want), "float32")
