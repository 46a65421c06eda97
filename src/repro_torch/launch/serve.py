"""Serving launcher: a CNNSelect-fronted multi-model server over real
engines, driven by a synthetic request stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 40 \\
        --sla 200 --network campus_wifi --policy cnnselect

Runs on the card (the CUDA kernels); ``--device cpu`` runs the same
path on the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.core.selection import make_policy, policy_names
from repro_torch.models import init_params
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.network import make_network
from repro_torch.serving.server import CNNSelectServer, ServedModel


def build_default_zoo(device="cuda"):
    """Three reduced engines spanning a latency/accuracy frontier, on the
    kernel path."""
    base = reduced_config("stablelm_1_6b", attn_impl="cuda")
    tiers = [
        ("xs", dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                    head_dim=16, d_ff=64), 0.50),
        ("s", dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=128), 0.72),
        ("m", dict(n_layers=6, d_model=160, n_heads=8, n_kv_heads=8,
                   head_dim=20, d_ff=320), 0.90),
    ]
    models = []
    for name, kw, acc in tiers:
        cfg = dataclasses.replace(base, **kw)
        params = init_params(cfg, 0, device=device)
        eng = InferenceEngine(cfg, params, batch_size=1, max_seq=64,
                              device=device)
        models.append(ServedModel(name=name, engine=eng, accuracy=acc))
    return models


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--sla", type=float, default=250.0)
    ap.add_argument("--network", default="campus_wifi")
    ap.add_argument("--policy", default="cnnselect",
                    help="registry spec: one of %s, or static:<name>"
                    % ", ".join(policy_names()))
    ap.add_argument("--t-threshold", type=float, default=30.0)
    ap.add_argument("--n-tokens", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Resolve the policy before building engines so a bad spec fails
    # immediately.
    policy = make_policy(args.policy, t_threshold=args.t_threshold)
    srv = CNNSelectServer(build_default_zoo(args.device),
                          t_threshold=args.t_threshold,
                          policy=policy, n_tokens=args.n_tokens)
    print("profiling zoo...", flush=True)
    srv.profile_models(prompt_len=8, reps=5)
    for p in srv.current_profiles():
        print(f"  {p.name}: mu={p.mu:.1f}ms sigma={p.sigma:.1f} "
              f"acc={p.accuracy:.2f}")

    net = make_network(args.network)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        req = Request(arrival=0.0, rid=i,
                      prompt=rng.integers(0, 50, 8).astype(np.int32),
                      t_input_ms=float(net.sample_t_input(rng, 1)[0]))
        rec = srv.handle(req, t_sla=args.sla)
        if i < 5 or (i + 1) % 10 == 0:
            print(f"req {i:3d}: model={rec['model']:3s} "
                  f"e2e={rec['e2e_ms']:7.1f}ms ok={rec['ok']}")
    print("\nsummary:", json.dumps(srv.metrics.summary(), indent=1))


if __name__ == "__main__":
    main()
