"""The port's checkpoint-codec kernels against the JAX package.

On the CPU the port's wrappers run the plain PyTorch versions of its
CUDA kernels; the JAX package runs its Pallas kernels in interpret mode.
Both, and the numpy oracle ``ref.py``, must agree bit for bit: the
fingerprints, the fused capture (count, indices, compacted payload,
overflow included), ``fused_capacity`` and the XOR delta. The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import ml_dtypes

from repro.kernels.ckpt_codec import ops as jops
from repro.kernels.ckpt_codec.ref import fingerprint_ref, fused_capture_ref
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels.ckpt_codec import ref as tref

CB = 1024  # 4 * BLOCK: one i32 lane row per chunk — the minimum legal


def _leaf(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if dtype == "bfloat16":
        return rng.randn(n).astype(ml_dtypes.bfloat16)
    if dtype == "float32":
        return rng.randn(n).astype(np.float32)
    if dtype == "int32":
        return rng.randint(-2**31, 2**31 - 1, size=n, dtype=np.int64) \
            .astype(np.int32)
    return rng.randint(0, 256, size=n).astype(np.uint8)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dirty(x: np.ndarray, chunks) -> np.ndarray:
    y = x.copy()
    b = y.view(np.uint8)
    for i in chunks:
        b[i * CB % b.size] ^= 0x5A
    return y


DTYPES = ("float32", "bfloat16", "int32", "uint8")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_bytes", [CB * 6, CB * 6 + 124, CB - 28, 12,
                                     CB * 3 + 2])
def test_fingerprint_matches_jax_and_oracle(dtype, n_bytes):
    itemsize = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                        else dtype).itemsize
    x = _leaf(dtype, max(1, n_bytes // itemsize), n_bytes)
    got = ops.chunk_fingerprints(_tensor(x), CB).numpy().view(np.uint32)
    want_jax = np.asarray(jops.chunk_fingerprints(x, CB, interpret=True))
    np.testing.assert_array_equal(got, want_jax.view(np.uint32))
    np.testing.assert_array_equal(got, fingerprint_ref(x, CB))


def test_fingerprint_at_the_main_path_chunk_size():
    x = _leaf("bfloat16", (tref.FP_CHUNK_BYTES * 2 + 4096) // 2, 7)
    got = ops.chunk_fingerprints(_tensor(x)).numpy()
    want = np.asarray(jops.chunk_fingerprints(x, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.uint32), fingerprint_ref(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_bytes,dirty", [
    (CB * 6, [1, 3]),               # even chunks, scattered dirty
    (CB * 6 + 124, [0, 6]),         # odd size, dirty partial tail chunk
    (CB * 6 + 124, []),             # all-clean
    (CB * 6 + 124, list(range(7))),  # all-dirty incl. tail
    (CB - 28, [0]),                 # single partial chunk, dirty
    (CB - 28, []),                  # single partial chunk, clean
    (12, [0]),                      # tiny leaf
])
def test_fused_capture_matches_jax_and_oracle(dtype, n_bytes, dirty):
    itemsize = np.dtype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                        else dtype).itemsize
    prev = _leaf(dtype, max(1, n_bytes // itemsize), n_bytes + len(dirty))
    x = _dirty(prev, dirty)
    pfp_j = jops.chunk_fingerprints(prev, CB, interpret=True)
    pfp_t = ops.chunk_fingerprints(_tensor(prev), CB)
    np.testing.assert_array_equal(pfp_t.numpy(), np.asarray(pfp_j))

    fp_t, idx_t, data_t = ops.fused_dirty_chunk_capture(_tensor(x), pfp_t,
                                                        CB)
    fp_j, idx_j, data_j = jops.fused_dirty_chunk_capture(x, pfp_j, CB,
                                                         interpret=True)
    fp_r, count_r, idx_r, data_r = fused_capture_ref(
        x, np.asarray(pfp_j).view(np.uint32), CB)
    np.testing.assert_array_equal(fp_t.numpy(), np.asarray(fp_j))
    np.testing.assert_array_equal(fp_t.numpy().view(np.uint32), fp_r)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(idx_t, idx_r)
    assert idx_t.dtype == np.int64 and count_r == idx_t.size
    n_chunks = -(-x.nbytes // CB)
    assert idx_t.size == len({i % n_chunks for i in dirty})
    if idx_t.size == 0:
        assert data_t is None and data_j is None
    else:
        np.testing.assert_array_equal(data_t, data_j)
        np.testing.assert_array_equal(data_t, data_r)
    # the two-launch path gives the same answer
    fp_o, idx_o, data_o = ops.dirty_chunk_capture(_tensor(x), pfp_t, CB)
    np.testing.assert_array_equal(fp_o.numpy(), fp_t.numpy())
    np.testing.assert_array_equal(idx_o, idx_t)
    if idx_t.size:
        np.testing.assert_array_equal(data_o, data_t)


@pytest.mark.parametrize("capacity", [1, 2, 8])
def test_fused_blocks_count_past_capacity_like_the_oracle(capacity):
    """The kernel-level output: the count runs past capacity (the
    overflow signal) while only the first ``capacity`` dirty chunks are
    compacted, in chunk order — exactly ``fused_capture_ref``."""
    prev = _leaf("float32", CB // 4 * 20 + 3, 11)
    x = _dirty(prev, [0, 2, 3, 7, 8, 13, 19, 20])
    pfp = ops.chunk_fingerprints(_tensor(prev), CB)
    fp, buf = ops.fused_capture_blocks(_tensor(x), pfp, CB, capacity)
    count, idx, compact = ops.fused_unpack(buf.numpy(), capacity, CB)
    fp_r, count_r, idx_r, data_r = fused_capture_ref(
        x, pfp.numpy().view(np.uint32), CB, capacity)
    assert count == count_r == 8
    np.testing.assert_array_equal(fp.numpy().view(np.uint32), fp_r)
    np.testing.assert_array_equal(idx[:idx_r.size], idx_r)
    np.testing.assert_array_equal(compact[:idx_r.size], data_r)


def test_fused_overflow_falls_back_like_jax():
    rng = np.random.RandomState(4)
    n_chunks = 4 * ops._FUSED_MIN_CAPACITY
    prev = rng.randn(n_chunks * CB // 4).astype(np.float32)
    x = prev + 1.0  # every chunk dirty
    assert ops.fused_capacity(n_chunks, CB, 1) < n_chunks
    pfp = ops.chunk_fingerprints(_tensor(prev), CB)
    fp_t, idx_t, data_t = ops.fused_dirty_chunk_capture(
        _tensor(x), pfp, CB, capacity_hint=1)
    fp_j, idx_j, data_j = jops.fused_dirty_chunk_capture(
        x, jops.chunk_fingerprints(prev, CB, interpret=True), CB,
        capacity_hint=1, interpret=True)
    np.testing.assert_array_equal(fp_t.numpy(), np.asarray(fp_j))
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(data_t, data_j)
    assert idx_t.tolist() == list(range(n_chunks))


def test_fused_capacity_matches_jax():
    for cb in (1024, 4096, 64 * 1024, tref.FP_CHUNK_BYTES, 8 << 20,
               16 << 20):
        for n_chunks in (1, 2, 3, 7, 8, 9, 31, 32, 33, 100, 1024, 4096):
            for hint in (None, 0, 1, 3, 4, 5, 16, 17, 100, 256, 5000):
                assert ops.fused_capacity(n_chunks, cb, hint) == \
                    jops.fused_capacity(n_chunks, cb, hint), \
                    (n_chunks, cb, hint)
    # the 8 MB budget clamp: 256 KiB chunks cap the buffer at 32 chunks
    assert ops.fused_capacity(1024, tref.FP_CHUNK_BYTES, 256) == 32


def test_one_fused_call_counts_one():
    """One fused capture is one call of the fused kernel (its plain
    version here) — overflow included — and never a fingerprint call;
    on a CPU tensor no CUDA launch is counted."""
    prev = _leaf("float32", CB // 4 * 40, 5)
    pfp = ops.chunk_fingerprints(_tensor(prev), CB)
    for dirty, outcome in (([3], "hits"), (list(range(40)), "overflows")):
        ops.reset_counts()
        ops.fused_dirty_chunk_capture(_tensor(_dirty(prev, dirty)), pfp, CB,
                                      capacity_hint=1)
        assert ops.counts("cpu") == dict(dict.fromkeys(ops.KERNELS, 0),
                                         fused_capture=1)
        assert ops.counts("cuda") == dict.fromkeys(ops.KERNELS, 0)
        assert ops.fused_outcomes()[outcome] == 1
    ops.reset_counts()


@pytest.mark.parametrize("n", [1, 1023, 1024, 4096 + 5, 3 * 4096])
def test_xor_delta_matches_jax_and_oracle(n):
    rng = np.random.RandomState(n)
    a = rng.randint(0, 256, size=n).astype(np.uint8)
    b = rng.randint(0, 256, size=n).astype(np.uint8)
    got = ops.delta_encode(a, b, device="cpu")
    np.testing.assert_array_equal(got, jops.delta_encode(a, b,
                                                         interpret=True))
    np.testing.assert_array_equal(got, tref.delta_encode_ref(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_delta_decode_roundtrip_keeps_bits(dtype):
    cur = _leaf(dtype, 999, 1)
    prev = _leaf(dtype, 999, 2)
    delta = ops.delta_encode(cur, prev, device="cpu")
    out = ops.delta_decode(delta, prev, dtype, (999,), device="cpu")
    want = cur.view(np.uint16) if dtype == "bfloat16" else cur
    assert out.dtype == want.dtype
    np.testing.assert_array_equal(out, want)


def test_delta_encode_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.delta_encode(np.zeros(8, np.uint8), np.zeros(8, np.uint8))


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(4096, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.fingerprint_blocks(x, CB)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.xor_blocks(x, x)
