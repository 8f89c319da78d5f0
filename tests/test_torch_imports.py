"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the JAX package
``repro`` (the machine with the card has none of them), checked by AST
scan and by importing the port with those modules blocked."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imports(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_the_scan_sees_the_whole_port():
    files = _port_files()
    assert "chip_smoke.py" in files
    for mod in ("api/session.py", "core/async_snapshot.py",
                "kernels/ckpt_codec/ops.py", "serving/engine.py",
                "models/model.py", "convert.py", "train/loop.py",
                "kernels/flash_attention/ops.py", "kernels/nvcc.py",
                "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ref.py",
                "models/ssm.py", "kernels/rg_lru/ops.py",
                "kernels/rg_lru/ref.py", "models/hybrid.py",
                "core/backends/sharded.py", "core/backends/cached.py",
                "core/replication.py", "core/delta.py",
                "core/failure.py", "core/supervisor.py", "core/churn.py",
                "core/migration.py", "serving/traffic.py",
                "launch/common.py", "launch/supervise.py",
                "launch/train.py", "launch/serve.py", "launch/fleet.py",
                "examples/rl_actor_learner.py"):
        assert os.path.join("src", "repro_torch", mod) in files


@pytest.mark.parametrize("path", _port_files())
def test_port_module_imports_no_jax_ml_dtypes_or_repro(path):
    bad = sorted(n for n in _imports(path) if _forbidden(n))
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_and_ml_dtypes_blocked():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
            sys.modules[name] = None      # any import of them now fails
        import repro_torch.api
        import repro_torch.convert
        import repro_torch.core.restore
        import repro_torch.kernels.ckpt_codec.ops
        import repro_torch.serving.engine
        import repro_torch.train.loop
        import repro_torch.kernels.flash_attention.ops
        import repro_torch.kernels.rg_lru.ops
        import repro_torch.models.hybrid
        import repro_torch.core.backends
        import repro_torch.core.replication
        import repro_torch.core.supervisor
        import repro_torch.core.churn
        import repro_torch.core.migration
        import repro_torch.serving.traffic
        import repro_torch.launch.train
        import repro_torch.launch.serve
        import repro_torch.launch.fleet
        import repro_torch.examples.rl_actor_learner
        from repro_torch.api.registry import resolve_backend
        import tempfile
        d = tempfile.mkdtemp()
        resolve_backend(f"cached:{d}/c?over=sharded:{d}/s?hosts=2")
        import shutil
        shutil.rmtree(d)
        from repro_torch.api import CheckpointSession, Policy
        from repro_torch.api.registry import resolve_app_kind
        resolve_app_kind("train")
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
