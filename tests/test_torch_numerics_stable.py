"""The port's other plain paths give the same bits in every process.

ROADMAP C18: the flash plain forward (bf16, with a window, at
``[1, 6, 130, 32]``) once gave an LSE 3.8e-5 off in one fresh process of
30, from ``torch.exp`` split over threads into MKL's vector math; the
RG-LRU plain version and the model's CPU attention took their
exponentials the same way. They now take them from
``repro_torch.kernels.numerics``. Here each of them runs on inputs drawn
from a seed with numpy in eight fresh Python processes — torch's thread
count 1, 4, 6 or 8, times inputs that start 0 or 1 element past an
aligned allocation — and every output must be byte-identical across
them and with this process's own run.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
THREADS = (1, 4, 6, 8)
OFFSETS = (0, 1)
CASES = ("flash_fwd_plain", "rg_lru_plain", "dense_attention")

# the three computations; ``place`` puts a numpy array into a torch
# tensor of the given dtype; ``cases`` maps each name to its outputs
_CASES = r"""
import numpy as np, torch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rg_lru import ref as rg
from repro_torch.models import layers

def cases(place):
    rng = np.random.RandomState(130)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    bf = torch.bfloat16
    q, k, v = place(f(1, 6, 130, 32), bf), place(f(1, 2, 130, 32), bf), \
        place(f(1, 2, 130, 32), bf)
    out = {"flash_fwd_plain": fa.flash_fwd_plain(q, k, v, causal=True,
                                                 window=48)}
    x = place(f(2, 200, 256), torch.float32)
    r = place(1 / (1 + np.exp(-f(2, 200, 256))), torch.float32)
    i = place(1 / (1 + np.exp(-f(2, 200, 256))), torch.float32)
    lam = place(np.log(np.expm1(-np.log(
        rng.uniform(0.9, 0.999, 256)))).astype(np.float32), torch.float32)
    h0 = place(f(2, 256), torch.float32)
    out["rg_lru_plain"] = (rg.rg_lru_plain(x, r, i, lam, h0),)
    qg = place(f(1, 130, 2, 3, 32), torch.float32)
    kk, vv = place(f(1, 130, 2, 32), torch.float32), \
        place(f(1, 130, 2, 32), torch.float32)
    pos = torch.arange(130, dtype=torch.int32)[None]
    out["dense_attention"] = (layers.dense_attention(
        qg, kk, vv, pos, pos, causal=True, window=48),)
    return out
"""

# one process: every case at one thread count and offset; prints
# "<case> <sha256 of each output>..." per case
_CHILD = _CASES + r"""
import hashlib, sys
threads, offset = int(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(threads)
def place(a, dtype):
    buf = torch.zeros(a.size + offset, dtype=dtype)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return t
for name, outs in cases(place).items():
    print(name, *(hashlib.sha256(t.float().numpy().tobytes()).hexdigest()
                  for t in outs))
"""


def _digests(lines: str) -> dict:
    out = {}
    for line in lines.strip().splitlines():
        name, *hashes = line.split()
        out[name] = tuple(hashes)
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env.pop(var, None)
    return env


def _here() -> dict:
    """The same computations in this process (its own thread count)."""
    import numpy as np
    import torch
    scope = {}
    exec(_CASES, scope)
    outs = scope["cases"](lambda a, dtype: torch.from_numpy(
        np.ascontiguousarray(a)).to(dtype))
    return {name: tuple(hashlib.sha256(t.float().numpy().tobytes())
                        .hexdigest() for t in ts)
            for name, ts in outs.items()}


@pytest.fixture(scope="module")
def runs():
    """{(threads, offset): {case: digests}}, the eight processes started
    together."""
    env = _env()
    procs = {(t, o): subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(t), str(o)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for t in THREADS for o in OFFSETS}
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{key}: {stderr}"
        out[key] = _digests(stdout)
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_path_is_byte_identical_across_processes(runs, case):
    assert len(runs) == len(THREADS) * len(OFFSETS) == 8
    want = _here()[case]
    for (threads, offset), got in runs.items():
        assert got[case] == want, (
            f"{case}: {threads} threads, inputs {offset} element(s) off an "
            f"aligned allocation gave other bits: {got[case]} vs {want}")
