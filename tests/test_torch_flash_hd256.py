"""The host side of the bf16 head-dim-256 flash route, on the CPU.

``csrc/flash_attention_hd256.cu`` (wgmma fed by TMA, warp-specialised
blocks that own the whole head dim) runs only on the card; its checks
against the plain versions are in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``. Here: which library takes a call of each dtype and
head dim, and that a CPU tensor takes neither; the grids and the dk/dv
split the kernels launch; and each kernel's shared-memory plan, as the
source states it, against the layout it describes and a block's
232,448 bytes, with the source's register budget and the ctypes
signatures of its C entry points.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.nvcc import CSRC

SOURCE = (CSRC / "flash_attention_hd256.cu").read_text()


def _const(name: str) -> int:
    """``constexpr int NAME = <integer>;`` from the source."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} is not stated as an integer in the source"
    return int(m.group(1))


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_per_dtype_and_head_dim(dtype, hd):
    """bfloat16 at head dim 256 goes to the wgmma library; every other
    call the kernels take stays on flash_attention.cu."""
    lib = fa.kernel_library(dtype, hd)
    if dtype == torch.bfloat16 and hd == 256:
        assert lib is fa.LIB256
        assert lib.source.name == "flash_attention_hd256.cu"
    else:
        assert lib is fa.LIB
        assert lib.source.name == "flash_attention.cu"


def test_cpu_tensors_at_head_dim_256_take_the_plain_versions():
    """A CPU tensor never reaches either library: no build, no load."""
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    q, k, v, do = mk(1, 2, 40, 256), mk(1, 1, 40, 256), mk(1, 1, 40, 256), \
        mk(1, 2, 40, 256)
    fa.reset_counts()
    out, lse = fa.flash_fwd(q, k, v, window=16)
    delta = fa.attention_delta(out, do)
    fa.flash_dq(q, k, v, do, lse, delta, window=16)
    fa.flash_dkv(q, k, v, do, lse, delta, window=16)
    assert fa.counts("cpu") == dict.fromkeys(fa.KERNELS, 1)
    assert fa.counts("cuda") == dict.fromkeys(fa.KERNELS, 0)
    assert fa.LIB256._lib is None and fa.LIB._lib is None


# B, H, Hkv, Sq, Skv -> (forward, dq, dk/dv) grids
GRIDS = [
    # recurrentgemma-9b's training attention: 128-row forward blocks,
    # 64-row dq blocks, dk/dv over 64 kv rows with the group of 16 split 4
    ((2, 16, 1, 4096, 4096), ((32, 32), (32, 64), (8, 64))),
    ((1, 16, 1, 700, 700), ((16, 6), (16, 11), (4, 11))),
    ((1, 4, 2, 130, 130), ((4, 2), (4, 3), (4, 3))),
    ((1, 4, 4, 333, 200), ((4, 3), (4, 6), (4, 4))),
    ((2, 2, 1, 130, 333), ((4, 2), (4, 3), (4, 6))),
    ((1, 6, 1, 64, 64), ((6, 1), (6, 1), (3, 1))),
]


@pytest.mark.parametrize("dims,want", GRIDS)
def test_hd256_grids_and_split(dims, want):
    B, H, Hkv, Sq, Skv = dims
    got = tuple(fa.hd256_grid(name, *dims) for name in fa.KERNELS)
    assert got == want
    split = fa.dkv_splits(H, Hkv)
    assert got[2][0] == B * Hkv * split and (H // Hkv) % split == 0
    # every query row lies in one forward block (two 64-row tiles) and
    # one dq block, every kv row in one dk/dv block
    rows = fa.HD256_ROWS
    assert 2 * rows * got[0][1] >= Sq > 2 * rows * (got[0][1] - 1)
    assert rows * got[1][1] >= Sq > rows * (got[1][1] - 1)
    assert rows * got[2][1] >= Skv > rows * (got[2][1] - 1)
    assert max(g[1] for g in got) <= fa.MAX_GRID_Y


def test_hd256_grid_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        fa.hd256_grid("flash_bwd", 1, 1, 1, 64, 64)


def test_shared_memory_plans_match_the_source():
    """Each plan as the source states it equals the layout it describes
    (tiles of 64 rows x 256 bf16, two ring stages, f32 64 x 64 exchange
    tiles, dk/dv's 64 x 64 bf16 tile of P^T's third term, 8-byte
    mbarriers, 1,024 bytes to align the swizzled tiles), as ops.py
    mirrors it, and fits a block on an H100."""
    tile = _const("BR") * 256 * 2
    xchg = _const("BR") * _const("BR") * 4
    box = _const("BR") * _const("BR") * 2
    stages, align = _const("STAGES"), _const("ALIGN")
    assert tile == 32768 and xchg == 16384 and stages == 2 and align == 1024
    layouts = {   # tiles, exchange tiles, bf16 64 x 64 tiles, mbarriers
        "flash_fwd": (2 + 2 * stages, 0, 0, 1 + 3 * stages),  # Q x2 | ring
        "flash_dq": (2 + 2 * stages, 2, 0, 1 + 2 * stages),  # .. | P, dP
        "flash_dkv": (2 + 2 * stages, 1, 1, 1 + 2 * stages),  # .. | P^T
    }
    names = {"flash_fwd": "FWD", "flash_dq": "DQ", "flash_dkv": "DKV"}
    for kern, (tiles, xs, boxes, bars) in layouts.items():
        stated = _const(f"{names[kern]}_SMEM_BYTES")
        assert stated == (tiles * tile + xs * xchg + boxes * box + 8 * bars
                          + align), kern
        assert stated == fa.HD256_SMEM_BYTES[kern]
        assert stated <= fa.SMEM_LIMIT == _const("SMEM_LIMIT") == 232448


def test_register_budget_matches_the_source():
    """Two consumer warpgroups and a producer: setmaxnreg moves
    registers between them within the SM's 65,536."""
    threads = _const("THREADS")
    cons, prod = _const("CONSUMER_REGS"), _const("PRODUCER_REGS")
    assert threads == fa.HD256_THREADS == 3 * 128
    assert cons % 8 == 0 and prod % 8 == 0 and 24 <= prod < cons <= 256
    assert 2 * 128 * cons + 128 * prod <= 65536


@pytest.mark.parametrize("fn", sorted(fa.LIB256.signatures))
def test_ctypes_signatures_match_the_c_entry_points(fn):
    m = re.search(rf"int {fn}\(([^)]*)\)", SOURCE)
    assert m, fn
    params = [p.strip() for p in m.group(1).split(",")]
    argtypes = fa.LIB256.signatures[fn]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        kind = ("ptr" if "*" in p else "float" if p.startswith("float")
                else "int")
        assert t is {"ptr": fa._VP, "float": fa._F32, "int": fa._INT}[kind], p
    assert re.search(rf"const char\* {fa.LIB256.error_fn}\(int code\)",
                     SOURCE)


def test_source_states_what_it_replaces():
    for ref in ("repro/kernels/flash_attention/kernel.py:86",
                "repro/kernels/flash_attention/backward.py:130"):
        assert ref in SOURCE
    assert (Path(fa.__file__).parents[2] / "csrc" /
            "flash_attention_hd256.cu").exists()
