"""The port's `InferenceEngine` (CPU tensors, kernel plain versions)
against the JAX reference engine on the same weights, plus the engine's
own pins: slot backfill against a from-scratch prefill, and the
fail-fast guards."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_params as jax_init_params
from repro.quant.int8 import quantize_exec_tree as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import reduced_config
from repro_torch.models import from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.quant.int8 import quantize_exec_tree
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.measured import build_model


def _weights(seed=1, **kw):
    jcfg = dataclasses.replace(jax_reduced_config("stablelm_1_6b"),
                               attn_impl="naive", **kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, from_jax(jp, device="cpu")


def _engine(params, impl="cuda", batch_size=2, max_seq=32, **kw):
    cfg = dataclasses.replace(reduced_config("stablelm_1_6b"),
                              attn_impl=impl, **kw)
    eng = InferenceEngine(cfg, params, batch_size=batch_size,
                          max_seq=max_seq, device="cpu")
    eng.warmup(prompt_len=8)
    return eng


@pytest.mark.parametrize("quant", [None, "int8"])
def test_greedy_tokens_match_jax_engine(quant):
    """Same weights, same prompts (one row left-padded): the port's
    kernel-path engine generates the JAX engine's greedy tokens (the JAX
    tests pin its naive and pallas impls to the same tokens)."""
    kw = dict(d_model=96, d_ff=192, n_layers=2)
    jcfg, jp, tp = _weights(6, **kw)
    if quant:
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab, (2, 6), dtype=np.int32)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=32)
    te = _engine(tp, **kw)
    np.testing.assert_array_equal(
        te.generate(prompts, 5, lengths=[6, 4]),
        je.generate(prompts, 5, lengths=[6, 4]))


@pytest.mark.parametrize("impl", ["naive", "cuda"])
def test_backfill_matches_from_scratch_prefill(impl):
    """Retire -> backfill lifecycle: a request joining mid-group via
    prefill_row sees logits (and subsequent decode steps) equal to a
    from-scratch prefill at the same absolute positions."""
    _, _, tp = _weights()
    rng = np.random.default_rng(6)
    p0, p1 = (rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2))
    p2 = rng.integers(0, 256, 5, dtype=np.int32)
    eng = _engine(tp, impl)
    logits = eng.run_prefill(np.stack([p0, p1]))
    hist1 = list(p1)
    for _ in range(2):                      # row0 retires after 2 tokens
        nxt = logits.argmax(-1).astype(np.int32)
        hist1.append(int(nxt[1]))
        logits = eng.run_decode(nxt[:, None])
    prompt = np.zeros(8, np.int32)
    prompt[3:] = p2
    lj = eng.prefill_row(prompt, 0, length=5)
    row0 = np.zeros(10, np.int32)
    row0[5:] = p2
    ref = _engine(tp, impl)
    lr = ref.run_prefill(np.stack([row0, np.asarray(hist1, np.int32)]),
                         lengths=[5, 10])
    np.testing.assert_allclose(lj, lr[0], atol=1e-4)
    np.testing.assert_allclose(logits[1], lr[1], atol=1e-4)
    nxt = np.stack([lj.argmax(-1), logits[1].argmax(-1)]).astype(np.int32)
    np.testing.assert_allclose(eng.run_decode(nxt[:, None]),
                               ref.run_decode(nxt[:, None]), atol=1e-4)
    assert eng.stats.backfill_calls == 1
    assert int(eng.valid_from[0]) == 10 - 5


def test_engine_guards():
    _, _, tp = _weights()
    eng = _engine(tp)
    fresh = InferenceEngine(eng.cfg, tp, batch_size=2, max_seq=32,
                            device="cpu")
    with pytest.raises(RuntimeError, match="no KV cache"):
        fresh.run_decode(np.zeros((2, 1), np.int32))
    with pytest.raises(RuntimeError, match="no KV cache"):
        fresh.prefill_row(np.zeros(4, np.int32), 0)
    eng.run_prefill(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="slot"):
        eng.prefill_row(np.zeros(4, np.int32), 9)
    with pytest.raises(ValueError, match="longer than current context"):
        eng.prefill_row(np.zeros(12, np.int32), 0)
    with pytest.raises(ValueError, match="lengths"):
        eng.run_prefill(np.zeros((2, 8), np.int32), lengths=[9, 1])
    full = InferenceEngine(eng.cfg, tp, batch_size=2, max_seq=8,
                           device="cpu")
    full.run_prefill(np.zeros((2, 8), np.int32))
    with pytest.raises(RuntimeError, match="KV cache full"):
        full.run_decode(np.zeros((2, 1), np.int32))
    ring = dataclasses.replace(eng.cfg, pattern=("local",), window=4)
    assert not InferenceEngine(ring, tp, batch_size=2, max_seq=32,
                               device="cpu")._backfillable


def test_engine_rejects_params_on_another_device():
    _, _, tp = _weights()
    cfg = reduced_config("stablelm_1_6b")
    meta = {**tp, "embed": torch.empty(tp["embed"].shape, device="meta")}
    with pytest.raises(ValueError, match="move them first"):
        InferenceEngine(cfg, meta, batch_size=2, max_seq=32, device="cpu")


def test_measured_profile_split_and_free_context():
    m = build_model("lm_tiny", batch_size=2, max_seq=32, device="cpu")
    eng = m.engine
    eng.warmup(8)
    p = eng.measured_profile(prompt_len=8, n_tokens=3, reps=2)
    assert set(p) == {"mu", "sigma", "prefill_ms", "per_token_ms",
                      "resident_bytes"}
    assert p["prefill_ms"] > 0 and p["per_token_ms"] > 0
    assert p["mu"] == pytest.approx(
        p["prefill_ms"] + 3 * p["per_token_ms"], rel=1e-9)
    assert eng.free_context == 32 - 8 - 3


def _two_groups(eng, rng, vocab):
    """One engine serves two groups in turn, the second with a shorter
    prompt than the first (so the first group's slots lie stale past it
    in the cache), and a backfill into the second. Returns the logits of
    every step, in order."""
    out = []

    def greedy():
        return out[-1].argmax(-1).astype(np.int32)[:, None]
    p1 = rng.integers(0, vocab, (2, 8), dtype=np.int32)
    out.append(eng.run_prefill(p1, lengths=[8, 5]))
    for _ in range(4):
        out.append(eng.run_decode(greedy()))
    p2 = rng.integers(0, vocab, (2, 5), dtype=np.int32)
    out.append(eng.run_prefill(p2, lengths=[5, 3]))
    for _ in range(2):
        out.append(eng.run_decode(greedy()))
    nxt = greedy()
    row = np.zeros(6, np.int32)
    row[2:] = rng.integers(0, vocab, 4, dtype=np.int32)
    out.append(eng.prefill_row(row, 0, length=4))
    nxt[0, 0] = out[-1].argmax(-1)
    out.append(eng.run_decode(nxt))
    for _ in range(2):
        out.append(eng.run_decode(greedy()))
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_two_groups_and_backfill_match_jax_engine(quant):
    """The persistent cache across groups and a backfill: the port's
    engine generates the JAX engine's greedy tokens at every step."""
    kw = dict(d_model=96, d_ff=192, n_layers=2)
    jcfg, jp, tp = _weights(9, **kw)
    if quant:
        jp, tp = jax_quantize(jp), quantize_exec_tree(tp)
    je = JaxEngine(jcfg, jp, batch_size=2, max_seq=32)
    te = _engine(tp, **kw)
    want = _two_groups(je, np.random.default_rng(9), jcfg.vocab)
    got = _two_groups(te, np.random.default_rng(9), jcfg.vocab)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


def _fresh_cache_run(eng, rng, vocab):
    """What _two_groups computes, through `models.model` on a fresh cache
    for each group (the backfill's row cache merged as the engine does)."""
    from repro_torch.models.model import (decode_step, forward, init_cache,
                                          prefill)
    cfg, params, out = eng.cfg, eng.params, []

    def group(T, lengths):
        toks = torch.from_numpy(rng.integers(0, vocab, (2, T),
                                             dtype=np.int32))
        vf = torch.tensor([T - n for n in lengths], dtype=torch.int32)
        lg, cache = prefill(params, toks, cfg, eng.max_seq,
                            logits_last_only=True, valid_from=vf)
        out.append(lg[:, 0].numpy())
        return cache, vf

    def decode(cache, pos, vf, n, nxt=None):
        for i in range(n):
            tok = out[-1].argmax(-1).astype(np.int32)[:, None] \
                if nxt is None or i else nxt
            lg, cache = decode_step(params, torch.from_numpy(tok), cache,
                                    pos + i, cfg, valid_from=vf)
            out.append(lg[:, 0].numpy())
    cache, vf = group(8, [8, 5])
    decode(cache, 8, vf, 4)
    cache, vf = group(5, [5, 3])
    decode(cache, 5, vf, 2)
    nxt = out[-1].argmax(-1).astype(np.int32)[:, None]
    row = np.zeros(6, np.int32)
    row[2:] = rng.integers(0, vocab, 4, dtype=np.int32)
    rc = init_cache(cfg, 1, eng.max_seq, device="cpu")
    lg, _ = forward(params, torch.from_numpy(row[None]), cfg, cache=rc,
                    positions=1 + torch.arange(6, dtype=torch.int32),
                    logits_last_only=True,
                    valid_from=torch.tensor([3], dtype=torch.int32))
    out.append(lg[0, 0].numpy())
    InferenceEngine._merge(cache, rc, 0, 1, 6)
    vf[0] = 3
    nxt[0, 0] = out[-1].argmax(-1)
    decode(cache, 7, vf, 3, nxt)
    return out


@pytest.mark.parametrize("impl, quant", [("naive", None), ("cuda", None),
                                         ("cuda", "int8")])
def test_engine_steps_match_model_on_fresh_cache(impl, quant):
    """The engine's steps over its one persistent cache (stale slots of
    an earlier group past the prompt) give the bits of `models.model`
    prefill / decode_step on a fresh cache, the backfill included; the
    cache and the static inputs keep their storage throughout."""
    kw = dict(d_model=96, d_ff=192, n_layers=2)
    _, _, tp = _weights(10, **kw)
    if quant:
        tp = quantize_exec_tree(tp)
    eng = _engine(tp, impl, **kw)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.cache)]
    static = [eng.valid_from.data_ptr(), eng._token.data_ptr(),
              eng._pos.data_ptr()]
    got = _two_groups(eng, np.random.default_rng(10), eng.cfg.vocab)
    want = _fresh_cache_run(eng, np.random.default_rng(10), eng.cfg.vocab)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), i
    assert [t.data_ptr() for t in tree_leaves(eng.cache)] == ptrs
    assert [eng.valid_from.data_ptr(), eng._token.data_ptr(),
            eng._pos.data_ptr()] == static
    assert eng.stats.graph_captures == eng.stats.graph_replays == 0
