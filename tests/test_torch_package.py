"""Guards of the PyTorch/CUDA port (`repro_torch`): it imports nothing of
JAX or of the reference package, its copies of the reference's
numpy-only modules stay verbatim, and its entry points run on the card
unless told otherwise, raising — never falling back to the CPU — when
there is none."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# Reference modules the port copies verbatim, up to the import rename
# (the numpy-only modules and the ported architectures' configs).
COPIED = ["core/registry.py", "core/selection.py", "core/profiles.py",
          "core/zoo.py", "configs/paper_zoo.py", "serving/batching.py",
          "serving/metrics.py", "serving/network.py", "serving/fleet.py",
          "serving/control.py", "serving/router.py", "serving/stack.py",
          "serving/server.py", "serving/loop.py", "configs/stablelm_1_6b.py",
          "configs/recurrentgemma_2b.py", "configs/mamba2_2_7b.py",
          "configs/gemma2_9b.py", "configs/yi_9b.py",
          "configs/deepseek_coder_33b.py", "configs/musicgen_large.py",
          "configs/chameleon_34b.py", "data/pipeline.py",
          "data/__init__.py", "serving/trace.py", "serving/simulator.py",
          "serving/cluster.py", "serving/scan_engine.py",
          "serving/cluster_engine.py"]
# Committed data the port copies byte for byte.
COPIED_DATA = ["configs/traces/reference_fleet.jsonl"]
# ... except these members, which the port rewrites in torch: in
# selection.py the batched CNNSelect; in scan_engine.py the column
# program (jitted lax.scan there, a loop of (D,) tensor ops here, with
# its device context), `_run_program`, the open-loop queue recurrence of
# `scan_event_phase` (the queue_scan kernel) and the module docstring;
# in cluster_engine.py the request-axis scan (`_COMPILED` / `_compile`,
# a jitted lax.scan there, the cluster_scan kernel here), its call in
# `scan_cluster_run` and the module docstring. The imports of a
# rewritten module hold the reference's.
REWRITTEN = {
    "core/selection.py": {"cnnselect_batch", "_BATCH_JIT",
                          "_jit_cnnselect_batch",
                          "CNNSelectPolicy.select_batch",
                          "CNNSelectPolicy.__doc__", "__doc__"},
    "serving/scan_engine.py": {
        "__doc__", "<other>", "F64", "_DEVICE", "scan_device", "_device",
        "_unfused", "_layout", "_take", "_core_init", "_core_estimate",
        "_core_observe", "_bank_init", "_bank_step", "_det_init",
        "_det_step", "_COMPILED", "_compile", "_program", "_run_program",
        "scan_event_phase"},
    "serving/cluster_engine.py": {"__doc__", "<other>", "_COMPILED",
                                  "_compile", "scan_cluster_run"},
}
# Members a rewritten module must define.
REQUIRED = {
    "core/selection.py": {"cnnselect_batch", "CNNSelectPolicy.select_batch"},
    "serving/scan_engine.py": {"scan_device", "_program", "_run_program",
                               "scan_event_phase", "scan_plan_batch",
                               "_pack_columns", "_assemble_events"},
    "serving/cluster_engine.py": {"scan_cluster_run"},
}

_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _renamed(text):
    return _IMPORT.sub(lambda m: f"{m.group(1)}{m.group(2)} repro_torch.",
                       text)


def _members(tree):
    """{qualified name: ast dump} of top-level statements and methods."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant):
            out["__doc__"] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = ast.dump(sub)
                elif isinstance(sub, ast.Expr):
                    out[f"{node.name}.__doc__"] = ast.dump(sub)
                else:
                    out.setdefault(f"{node.name}.<body>", []).append(
                        ast.dump(sub))
            out[node.name] = (node.name, [ast.dump(b) for b in node.bases])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            out[ast.unparse(tgt)] = ast.dump(node)
        else:
            out.setdefault("<other>", []).append(ast.dump(node))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_numpy_copies_equal_reference(rel):
    want = _renamed((SRC / "repro" / rel).read_text())
    got = (SRC / "repro_torch" / rel).read_text()
    if rel not in REWRITTEN:
        assert got == want
        return
    a, b = _members(ast.parse(want)), _members(ast.parse(got))
    for name in set(a) | set(b):
        if name not in REWRITTEN[rel]:
            assert a.get(name) == b.get(name), name
    assert set(a.get("<other>", [])) <= set(b.get("<other>", []))
    assert REQUIRED[rel] <= set(b)


@pytest.mark.parametrize("rel", COPIED_DATA)
def test_data_copies_equal_reference(rel):
    want = (SRC / "repro" / rel).read_bytes()
    assert (SRC / "repro_torch" / rel).read_bytes() == want


def test_no_jax_or_reference_imports_in_source():
    bad = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\b)",
                     re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits


BLOCKED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules)
print(len(mods))
"""


def test_port_imports_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT,
                        str(ROOT / "chip_smoke.py")],
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 30


@pytest.fixture
def no_card(monkeypatch):
    """What every entry point sees on a host without a CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_card,
                                                           tmp_path):
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.models import from_jax, init_cache, init_params
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.measured import build_model, build_zoo
    from repro_torch.launch import train
    from repro_torch.configs.paper_zoo import paper_profiles
    from repro_torch.serving.simulator import SimConfig, simulate
    from repro_torch.serving.cluster import Cluster, make_tenant_workload
    from repro_torch.serving.stack import SimReplicaStack
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optim import adamw, constant_schedule
    from repro_torch.training.step import init_train_state
    cfg = reduced_config("stablelm_1_6b")
    params = init_params(cfg, 0, device="cpu")
    opt = adamw(constant_schedule(1e-3))
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, {"w": torch.zeros(2)}, step=1)
    calls = [lambda: init_params(cfg, 0),
             lambda: init_cache(cfg, 1, 8),
             lambda: from_jax({"w": torch.zeros(2).numpy()}),
             lambda: InferenceEngine(cfg, params, batch_size=1, max_seq=8),
             lambda: build_model("lm_tiny"),
             lambda: build_zoo(["lm_tiny"]),
             lambda: serve.main(["--requests", "1"]),
             lambda: init_train_state(cfg, opt),
             lambda: train.main(["--reduced", "--steps", "1"]),
             lambda: restore_checkpoint(ck, {"w": torch.zeros(2,
                                                             device="meta")}),
             lambda: simulate(paper_profiles(), SimConfig(
                 t_sla=300.0, n_requests=20, t_estimator="ewma:0.2",
                 engine="scan")),
             lambda: simulate(paper_profiles(), SimConfig(
                 t_sla=300.0, n_requests=20, arrival_rate_hz=50.0,
                 n_servers=2, engine="scan")),
             lambda: Cluster([SimReplicaStack(paper_profiles(), seed=1)],
                             "consumer_burst", engine="scan").run(
                 make_tenant_workload("consumer_burst", n_requests=20,
                                      rate_hz=40.0))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_get_config_names_the_later_slice():
    from repro_torch.configs import get_config
    assert get_config("stablelm-1.6b").d_model == 2048
    for arch in ("qwen3_moe_235b", "grok_1_314b"):
        with pytest.raises(NotImplementedError, match="later slice"):
            get_config(arch)


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)], env=env,
                           cwd=script.parent, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
