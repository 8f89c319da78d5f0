"""The port's launchers (``repro_torch.launch.{train,serve,fleet}``)
in-process through ``main(argv)`` with ``--device cpu``, against the JAX
package's launchers run with the same arguments:

* ``train --supervise --hosts 4 --kill-host 2@8`` with one spare (hot
  spare), none (shrink) and ``--no-shrink`` (restart), at
  starcoder2-3b-smoke in float32: every step's loss, the rolled-back
  steps' again included, within 1e-5, and the same incidents. Both runs
  start from one initial state: the port resumes the JAX launcher's own
  step-0 checkpoint of the same command line (``--steps 0``), since the
  two packages' seeded inits draw different numbers;
* ``serve`` with the same three and with ``--migrate-to 3@2``, at
  phi4-mini-3.8b-smoke in float32 (the port given the JAX init's params,
  converted, in place of its seeded init): every request's tokens
  equal, the same incidents and slot counts;

The JAX launchers build their device mesh with ``jax.make_mesh``, whose
Explicit axes make jax 0.9's train and serve steps raise (ROADMAP C4);
here it builds the Auto-axis mesh the JAX package's own tests build by
hand. Also: the shared flag parsing gives both packages' answers, and
every launcher refuses to start without a card unless the CPU is asked.
"""
import argparse
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.configs.phi4_mini_3_8b as jphi
import repro.configs.starcoder2_3b as jsc
import repro_torch.configs.phi4_mini_3_8b as tphi
import repro_torch.configs.starcoder2_3b as tsc
from repro.launch import common as jcommon
from repro.launch import serve as jserve
from repro.launch import supervise as jsup
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.launch import common as tcommon
from repro_torch.launch import fleet as tfleet
from repro_torch.launch import serve as tserve
from repro_torch.launch import supervise as tsup
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.train import loop as tloop


def _auto_mesh(shape, axes, **_):
    return jax.sharding.Mesh(
        np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)


def _patch_f32(mp):
    mp.setattr(jax, "make_mesh", _auto_mesh)
    for mod in (jsc, jphi, tsc, tphi):
        plain = mod.smoke_config
        mp.setattr(mod, "smoke_config",
                   lambda plain=plain: plain().replace(dtype="float32"))


@pytest.fixture
def f32(monkeypatch):
    """Both packages' starcoder2-3b and phi4-mini-3.8b smoke configs in
    float32, and the JAX launchers on an Auto-axis mesh."""
    _patch_f32(monkeypatch)


@pytest.fixture(scope="module", autouse=True)
def _jax_steps_build_once():
    """The JAX launchers build a fresh jitted step function for every
    trainer and engine, and each compiles anew; in this module each
    (function, arch, shape, plan) is built once and shared — the same
    function, so the same numbers, compiled once."""
    from repro.core import split_state as jss
    with pytest.MonkeyPatch.context() as mp:
        for name in ("train_step", "decode_step", "prefill_step"):
            def once(arch, shape_key, plan_key, lower,
                     build=jss.FUNCTION_REGISTRY[name], built={}):
                key = (arch, shape_key, plan_key)
                if key not in built:
                    built[key] = build(arch, shape_key, plan_key, lower)
                return built[key]
            mp.setitem(jss.FUNCTION_REGISTRY, name, once)
        yield


def _losses(monkeypatch, loop):
    """Record every step's (step, loss) the package's trainer takes."""
    seen = []
    plain = loop.Trainer.train_steps

    def train_steps(self, n):
        m = plain(self, n)
        seen.append((int(m["step"]), float(m["loss"])))
        return m
    monkeypatch.setattr(loop.Trainer, "train_steps", train_steps)
    return seen


def _incidents(out):
    return re.findall(r"\[supervisor\] incident (\S+): dead=(\[[^\]]*\]) "
                      r"step=(\S+)", out)


TRAIN = ["--arch", "starcoder2-3b-smoke", "--shape", "train_s32_b4",
         "--ckpt-every", "4", "--supervise", "--hosts", "4", "--kill-host",
         "2@8"]
POLICIES = {"hot-spare": ["--spares", "1"], "shrink": ["--spares", "0"],
            "restart": ["--spares", "0", "--no-shrink"]}
ACTIONS = {"hot-spare": "hot_spare", "shrink": "shrink",
           "restart": "restart_last_ckpt"}


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """The JAX launcher's step-0 checkpoint of the supervised command
    line (``--steps 0``: the baseline snapshot, no step), which the port
    resumes."""
    store = tmp_path_factory.mktemp("step0") / "s"
    with pytest.MonkeyPatch.context() as mp:
        _patch_f32(mp)
        assert jtrain.main(TRAIN + ["--steps", "0", "--store",
                                    f"localfs:{store}"]) == 0
    return store


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_train_launcher_matches_jax(f32, monkeypatch, capsys, tmp_path,
                                    step0, policy):
    argv = TRAIN + POLICIES[policy] + ["--steps", "12"]
    shutil.copytree(step0, tmp_path / "t")
    jseen = _losses(monkeypatch, jloop)
    assert jtrain.main(argv + ["--store", f"localfs:{tmp_path}/j"]) == 0
    jout = capsys.readouterr().out
    tseen = _losses(monkeypatch, tloop)
    assert ttrain.main(argv + ["--store", f"localfs:{tmp_path}/t",
                               "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert "RESUMED starcoder2-3b-smoke at step 0" in tout
    assert [s for s, _ in tseen] == [s for s, _ in jseen]
    np.testing.assert_allclose([v for _, v in tseen],
                               [v for _, v in jseen], rtol=0, atol=1e-5)
    assert _incidents(tout) == _incidents(jout)
    assert [a for a, _, _ in _incidents(tout)] == [ACTIONS[policy]]
    assert "done at step 12" in tout


SERVE = ["--arch", "phi4-mini-3.8b-smoke", "--slots", "4", "--max-seq",
         "64", "--requests", "6", "--max-new", "12"]
SERVE_RUNS = {p: ["--supervise", "--hosts", "4", "--kill-host", "2@8"] + f
              for p, f in POLICIES.items()}
SERVE_RUNS["migrate"] = ["--migrate-to", "3@2"]


def _tokens(out):
    return {int(m[0]): m[1] for m in re.findall(r"  rid=(\d+) out=(\[.*\])",
                                                out)}


def _decisions(out):
    return re.findall(r"\[supervisor\] (\w+): dead=(\[[^\]]*\]) -> "
                      r"hosts=(\[[^\]]*\])", out)


def jax_init(monkeypatch, seed):
    """The port's launcher builds the JAX package's params for ``seed``
    (converted) in place of its own seeded init."""
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, JM.init_params(jphi.smoke_config(),
                                   jax.random.PRNGKey(seed))), "cpu")
    monkeypatch.setattr(TM, "init_params", lambda cfg, seed, device: params)


@pytest.mark.parametrize("run", sorted(SERVE_RUNS))
def test_serve_launcher_matches_jax(f32, monkeypatch, capsys, tmp_path,
                                    run):
    argv = SERVE + SERVE_RUNS[run]
    assert jserve.main(argv + ["--store", f"localfs:{tmp_path}/j"]) == 0
    jout = capsys.readouterr().out
    jax_init(monkeypatch, 0)
    assert tserve.main(argv + ["--store", f"localfs:{tmp_path}/t",
                               "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert len(_tokens(tout)) == 6
    assert _tokens(tout) == _tokens(jout)
    assert _decisions(tout) == _decisions(jout)
    if run == "migrate":
        assert "migrated 6 sessions -> 3-slot engine at step 2" in tout
    else:
        assert [d[0] for d in _decisions(tout)] == [ACTIONS[run]]
    slots = re.findall(r"engine steps, (\d+) slots\)", tout)
    assert slots == re.findall(r"engine steps, (\d+) slots\)", jout)


@pytest.mark.parametrize("main,argv", [
    (ttrain.main, ["--arch", "starcoder2-3b-smoke", "--store", "localfs:X"]),
    (tserve.main, ["--arch", "phi4-mini-3.8b-smoke"]),
    (tfleet.main, ["--arch", "phi4-mini-3.8b-smoke", "--store",
                   "localfs:X"]),
], ids=["train", "serve", "fleet"])
def test_launchers_need_the_card_unless_the_cpu_is_asked(
        monkeypatch, tmp_path, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("X", str(tmp_path)) for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_serve_launcher_refusals(capsys):
    assert tserve.main(["--arch", "phi4-mini-3.8b-smoke", "--migrate-to",
                        "2@1", "--device", "cpu"]) == 2
    assert "--migrate-to needs --store" in capsys.readouterr().err
    assert tserve.main(["--arch", "phi4-mini-3.8b-smoke", "--drain", "0@3",
                        "--device", "cpu"]) == 2
    assert tserve.main(["--arch", "phi4-mini-3.8b-smoke", "--supervise",
                        "--store", "localfs:/nowhere", "--drain", "9@3",
                        "--device", "cpu"]) == 2
    assert "not in the simulated world" in capsys.readouterr().err
    assert ttrain.main(["--arch", "starcoder2-3b-smoke",
                        "--device", "cpu"]) == 2
    assert "a checkpoint store is required" in capsys.readouterr().err


# --- the shared flag surface, in both packages -------------------------------------

def _answers(sup, common, argv, tmp_path):
    ap = argparse.ArgumentParser()
    sup.add_supervise_args(ap)
    common.add_store_args(ap)
    args = ap.parse_args(argv)
    kill, err = sup.parse_supervise_args(args, "t")
    out = [kill, err]
    if err is None:
        out.append(sup.parse_drain_arg(args, "t"))
        trace, err = sup.parse_churn_args(args, "t", horizon=20)
        out.append((trace.to_jsonl() if trace is not None else None, err))
    out.append(common.resolve_store(args, "t"))
    out.append(common.parse_resume_arg(args, "t"))
    return out


FLAG_CASES = [
    ["--supervise"],
    ["--supervise", "--hosts", "4", "--kill-host", "2@8"],
    ["--supervise", "--hosts", "4", "--kill-host", "4@8"],
    ["--supervise", "--kill-host", "nope"],
    ["--supervise", "--hosts", "4", "--kill-host", "1@3", "--kill-host",
     "2@9", "--drain", "0@5", "--drain", "3@7"],
    ["--supervise", "--hosts", "4", "--kill-host", "1@3", "--drain", "1@5"],
    ["--kill-host", "1@2"], ["--no-shrink"], ["--hosts", "8"],
    ["--supervise", "--hosts", "4", "--churn", "poisson:rate=0.5,seed=3"],
    ["--supervise", "--churn", "poisson:wat=1"],
    ["--supervise", "--churn", "racks:rate=0.3,size=2,seed=2"],
    ["--store", "sharded:/x?hosts=4", "--resume"],
    ["--ckpt-dir", "/x", "--backend", "sharded", "--resume", "7"],
    ["--store", "localfs:/a", "--ckpt-dir", "/b", "--resume", "x"],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=[" ".join(a)
                                                  for a in FLAG_CASES])
def test_flag_parsing_matches_jax(argv, tmp_path):
    assert _answers(tsup, tcommon, argv, tmp_path) == \
        _answers(jsup, jcommon, argv, tmp_path)


def test_build_session_refusals_match_jax(tmp_path):
    for kw in ({"keep_last": 0}, {"interval": -1}):
        ts, terr = tcommon.build_session(f"localfs:{tmp_path}/t", "t", **kw)
        js, jerr = jcommon.build_session(f"localfs:{tmp_path}/j", "t", **kw)
        assert ts is None and js is None and terr == jerr
    ts, terr = tcommon.build_session("s3:/nope", "t")
    assert ts is None and "register_backend" in terr
    ts, terr = tcommon.build_session(f"localfs:{tmp_path}/t", "t",
                                     interval=0)
    assert terr is None and ts.policy.interval is None
    ts.close()


def test_driver_warns_when_a_kill_never_fires(capsys):
    class _Sup:
        world, incidents = [0, 1], []

        class policy:
            spares = []

        def beat(self, host, step):
            pass

        def poll(self):
            return None
    d = tsup.SimWorldDriver(kill=(1, 99)).attach(_Sup())
    d.tick(1)
    d.warn_if_kill_pending()
    assert "never fired" in capsys.readouterr().err
    d = tsup.SimWorldDriver(kill=(1, 1)).attach(_Sup())
    d.tick(1)
    d.warn_if_kill_pending()
    assert "never produced an incident" in capsys.readouterr().err
