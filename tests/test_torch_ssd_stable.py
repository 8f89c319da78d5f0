"""The port's plain SSD scan gives the same bits in every process.

``ssd_chunked_plain`` runs on ``test_torch_ssm.py``'s first scan shape
(B, S, H, hd, N, chunk = 2, 256, 3, 32, 16, 64; inputs drawn as there,
seed 256), without and with an initial state, in sixteen fresh Python
processes: torch's thread count 1, 2, 4 or 6, times inputs that start 0
or 1 float past an aligned allocation, each twice. ``y`` and the final
state must be byte-identical across all of them and with this process's
own run (ROADMAP C16: ``torch.exp`` split over threads gave other bits
in about one process in four at 6 threads). ``exp_f32``, the scan's
exponential, is also held to float64's ``exp`` and to its own bits on
any split of its input.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ref as R

SRC = Path(__file__).resolve().parents[1] / "src"
SHAPE = (2, 256, 3, 32, 16, 64)
THREADS = (1, 2, 4, 6)
OFFSETS = (0, 1)
REPEATS = 2
CASES = ("no_init", "init_state")

# one process: both cases at one thread count and offset; prints
# "<case> <sha256 of y> <sha256 of the final state>" per case
_CHILD = r"""
import hashlib, sys
import numpy as np, torch
threads, offset = int(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(threads)
from repro_torch.kernels.ssd_scan import ref as R
B, S, H, hd, N, chunk = {shape}
rng = np.random.RandomState(S)
f = lambda *s: rng.randn(*s).astype(np.float32)
ins = [f(B, S, H, hd), np.logaddexp(f(B, S, H), 0).astype(np.float32),
       -np.exp(f(H) * 0.3).astype(np.float32), f(B, S, N), f(B, S, N),
       f(B, H, hd, N)]
def place(a):
    buf = torch.zeros(a.size + offset, dtype=torch.float32)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t
ts = [place(a) for a in ins]
for case, init in (("no_init", None), ("init_state", ts[5])):
    y, fin = R.ssd_chunked_plain(*ts[:5], chunk, init)
    print(case, *(hashlib.sha256(t.numpy().tobytes()).hexdigest()
                  for t in (y, fin)))
"""


def _digests(lines: str) -> dict:
    out = {}
    for line in lines.strip().splitlines():
        case, y, fin = line.split()
        out[case] = (y, fin)
    return out


def _here() -> dict:
    """The same computation in this process (its own thread count)."""
    B, S, H, hd, N, chunk = SHAPE
    rng = np.random.RandomState(S)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    ins = [f(B, S, H, hd), np.logaddexp(f(B, S, H), 0).astype(np.float32),
           -np.exp(f(H) * 0.3).astype(np.float32), f(B, S, N), f(B, S, N),
           f(B, H, hd, N)]
    ts = [torch.from_numpy(a) for a in ins]
    out = {}
    for case, init in (("no_init", None), ("init_state", ts[5])):
        y, fin = R.ssd_chunked_plain(*ts[:5], chunk, init)
        out[case] = tuple(hashlib.sha256(t.numpy().tobytes()).hexdigest()
                          for t in (y, fin))
    return out


@pytest.fixture(scope="module")
def runs():
    """{(threads, offset, repeat): {case: (y digest, final digest)}}, the
    sixteen processes started eight at a time."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env.pop(var, None)
    code = _CHILD.format(shape=SHAPE)
    out = {}
    for r in range(REPEATS):
        procs = {(t, o, r): subprocess.Popen(
            [sys.executable, "-c", code, str(t), str(o)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for t in THREADS for o in OFFSETS}
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=120)
            assert proc.returncode == 0, f"{key}: {stderr}"
            out[key] = _digests(stdout)
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_scan_is_byte_identical_across_processes(runs, case):
    assert len(runs) == len(THREADS) * len(OFFSETS) * REPEATS == 16
    want = _here()[case]
    for (threads, offset, _), got in runs.items():
        assert got[case] == want, (
            f"{case}: {threads} threads, inputs {offset} float(s) off an "
            f"aligned allocation gave other bits (y, final state): "
            f"{got[case]} vs {want}")


def test_exp_f32_is_within_two_ulp_and_split_free():
    x = torch.cat([torch.linspace(-87.0, 88.0, 200_001),
                   torch.tensor([0.0, -0.0, -103.9, -150.0, 95.0,
                                 float("-inf"), float("inf"), float("nan")])])
    got = R.exp_f32(x)
    want = torch.exp(x[:200_001].double())
    rel = (got[:200_001].double() - want).abs() / want
    assert float(rel.max()) <= 2 * 2.0 ** -24
    tail = got[200_001:]
    assert tail[:2].tolist() == [1.0, 1.0]
    assert 0 < float(tail[2]) < 1e-44          # subnormal, not flushed
    assert tail[3:5].tolist() == [0.0, float("inf")]
    assert tail[5] == 0 and tail[6] == float("inf") and tail[7].isnan()
    # every element's bits depend on its value alone
    parts = torch.cat([R.exp_f32(c.clone()) for c in x.split(777)])
    assert torch.equal(parts.view(torch.int32), got.view(torch.int32))
    # gradient: g * exp_f32(x); exp(-inf) = 0 gives a zero, not a NaN
    xs = torch.tensor([-1.0, 0.5, float("-inf")], requires_grad=True)
    R.exp_f32(xs).sum().backward()
    assert torch.equal(xs.grad, R.exp_f32(xs.detach()))
