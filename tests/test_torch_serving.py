"""The port's serving stack on CPU engines: the torch `cnnselect_batch`
against the scalar numpy `cnnselect` (base model, exploration set and
probabilities exactly; the Gumbel sampling as a distribution), and
`CNNSelectServer` / `ServingLoop` serving requests end to end."""

import numpy as np
import pytest

from repro.core.selection import cnnselect as ref_cnnselect
from repro_torch.core.selection import (CNNSelectPolicy, ModelProfile,
                                        cnnselect, make_policy)
from repro_torch.serving.batching import Request
from repro_torch.serving.loop import ServingLoop
from repro_torch.serving.measured import (build_zoo, measured_profiles,
                                          served_models)
from repro_torch.serving.server import CNNSelectServer


def random_zoo(rng, k):
    mu = np.sort(rng.uniform(10.0, 500.0, k))
    sg = rng.uniform(1.0, 30.0, k)
    acc = np.sort(rng.uniform(0.3, 0.99, k))
    return [ModelProfile(f"m{i}", float(acc[i]), float(mu[i]), float(sg[i]))
            for i in range(k)]


@pytest.mark.parametrize("stage2_variant", ["figure", "text"])
@pytest.mark.parametrize("zoo_seed", [0, 1, 2])
def test_cnnselect_batch_matches_scalar(stage2_variant, zoo_seed):
    rng = np.random.default_rng(zoo_seed)
    profs = random_zoo(rng, k=3 + zoo_seed * 2)
    n = 64
    t_sla = rng.uniform(40.0, 1500.0, n)
    t_input = rng.uniform(0.0, 200.0, n)
    pol = CNNSelectPolicy(t_threshold=40.0, stage2_variant=stage2_variant,
                          seed=zoo_seed, chunk=32)      # >1 chunk
    batch = pol.select_batch(profs, t_sla, t_input, detail=True)
    for i in range(n):
        r = cnnselect(profs, float(t_sla[i]), float(t_input[i]), 40.0,
                      np.random.default_rng(0), stage2_variant)
        # The port's scalar path is the reference's, verbatim.
        j = ref_cnnselect(profs, float(t_sla[i]), float(t_input[i]),
                              40.0, np.random.default_rng(0), stage2_variant)
        np.testing.assert_array_equal(r.probs, j.probs)
        assert int(batch.base[i]) == r.base_index, i
        np.testing.assert_array_equal(batch.eligible[i], r.eligible)
        np.testing.assert_allclose(batch.probs[i], r.probs, atol=1e-4)
        assert r.eligible[int(batch.indices[i])]


def test_cnnselect_batch_samples_its_probabilities():
    """Gumbel-max draws follow probs: frequencies over many identical
    requests within 5 standard errors of each probability."""
    profs = [ModelProfile("a", 0.6, 40.0, 5.0),
             ModelProfile("b", 0.7, 60.0, 5.0),
             ModelProfile("c", 0.8, 75.0, 5.0)]
    n = 20000
    pol = CNNSelectPolicy(t_threshold=30.0, seed=3)
    out = pol.select_batch(profs, np.full(n, 120.0), np.full(n, 10.0),
                           detail=True)
    p = out.probs[0]
    assert (p > 0.05).sum() >= 2            # a real choice to make
    freq = np.bincount(out.indices, minlength=3) / n
    se = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 5 * se + 1e-12), (freq, p)
    # Seeded: the same policy seed draws the same selections.
    again = CNNSelectPolicy(t_threshold=30.0, seed=3).select_batch(
        profs, np.full(n, 120.0), np.full(n, 10.0))
    np.testing.assert_array_equal(out.indices, again)


@pytest.fixture(scope="module")
def zoo():
    return build_zoo(["lm_tiny", "lm_small_int8"], batch_size=2, max_seq=32,
                     device="cpu")


def test_server_serves_with_cnnselect(zoo):
    srv = CNNSelectServer(served_models(zoo), t_threshold=20.0,
                          policy=make_policy("cnnselect", t_threshold=20.0),
                          n_tokens=3)
    srv.profile_models(prompt_len=8, reps=2)
    assert all(p.mu > 0 for p in srv.current_profiles())
    rng = np.random.default_rng(0)
    for i in range(6):
        rec = srv.handle(Request(arrival=0.0, rid=i,
                                 prompt=rng.integers(0, 50, 8)
                                 .astype(np.int32),
                                 t_input_ms=5.0), t_sla=1e4)
        assert rec["model"] in zoo and len(rec["tokens"]) == 3
    s = srv.metrics.summary()
    assert s["served"] == 6 and s["attainment"] == 1.0


def test_loop_backfills_and_serves_every_request(zoo):
    profs = measured_profiles(zoo, prompt_len=8, n_tokens=2, reps=1)
    loop = ServingLoop({n: m.engine for n, m in zoo.items()},
                       profiles=profs, t_threshold=20.0)
    rng = np.random.default_rng(1)
    reqs = [Request(arrival=0.0 if i < 2 else float(i) * 1e-3, rid=i,
                    prompt=rng.integers(0, 50, int(rng.integers(3, 8)))
                    .astype(np.int32),
                    max_new_tokens=2 + i % 3, sla_ms=1e5, t_input_ms=5.0)
            for i in range(8)]
    m = loop.run(reqs)
    assert m.summary()["served"] == 8
    done = [r for b in loop.batchers.values() for r in b.done]
    assert all(len(r.tokens) == r.max_new_tokens for r in done)
    assert sum(z.engine.stats.backfill_calls for z in zoo.values()) > 0
