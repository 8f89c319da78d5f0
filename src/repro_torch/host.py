"""Host-side tensor helpers shared by the port's checkpoint core, model
and converters: device resolution, dtype names, and byte views.

Host payloads in the checkpoint core are numpy arrays or CPU tensors.
numpy has no bfloat16 (and the port does not depend on ``ml_dtypes``),
so a bfloat16 leaf decoded on the host is held as its ``uint16`` bit
view, while every manifest keeps the dtype string ``"bfloat16"`` — the
same string the JAX package writes.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

# manifest dtype string <-> torch dtype (numpy's names, as the JAX
# package writes them)
TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.
    Without a card, ``None`` raises instead of falling back to the CPU —
    a CPU run is something the caller asks for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def dtype_name(x: Any) -> str:
    """The manifest dtype string of a tensor or array leaf (read from
    the leaf's ``dtype`` where it has one, so a coded leaf is never
    decoded to answer)."""
    if isinstance(x, torch.Tensor):
        return _NAMES[x.dtype]
    dt = getattr(x, "dtype", None)
    return str(dt if isinstance(dt, np.dtype) else np.asarray(x).dtype)


def torch_dtype(name: str) -> torch.dtype:
    return TORCH_DTYPES[name]


def host_np_dtype(name: str) -> np.dtype:
    """numpy dtype a host buffer of manifest dtype ``name`` is held in
    (bfloat16 -> its uint16 bit view)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    n = getattr(x, "nbytes", None)
    return int(n) if n is not None else np.asarray(x).nbytes


def numel(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    n = getattr(x, "size", None)
    return int(n) if isinstance(n, (int, np.integer)) else np.asarray(x).size


def byte_view(x: Any) -> np.ndarray:
    """Flat uint8 numpy view of a C-contiguous host leaf (CPU tensor or
    numpy array). A view, not a copy: writing through it writes the
    leaf, which is how the snapshot mirror is patched in place."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or not x.is_contiguous():
            raise ValueError("byte_view needs a contiguous CPU tensor")
        return x.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        raise ValueError("byte_view needs a C-contiguous array")
    return a.reshape(-1).view(np.uint8)


def host_copy(x: Any) -> Any:
    """A private host copy: a CPU tensor for tensor leaves (``.cpu()``
    and ``.numpy()`` alias a CPU source, so the copy is explicit), a
    numpy array for everything else."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    return np.array(x)


def host_array(x: Any) -> np.ndarray:
    """A private numpy copy of a leaf's bytes with its logical shape
    (bfloat16 as its uint16 bit view)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def to_tensor(v: Any, dtype: torch.dtype,
              device: Optional[torch.device]) -> torch.Tensor:
    """Host leaf -> tensor of ``dtype`` on ``device``. A ``uint16`` host
    array bound for a bfloat16 tensor is its bit view, not a value. A
    coded leaf (``core.delta.Int8Leaf``) is dequantized on ``device``,
    which it must name: its full-width values never exist anywhere
    else."""
    from repro_torch.core.delta import Int8Leaf
    if isinstance(v, Int8Leaf):
        if device is None:
            raise ValueError("a coded leaf is dequantized where it lands: "
                             "name its device")
        t = v.tensor(device)
        return t if t.dtype == dtype else t.to(dtype)
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.asarray(v, order="C")    # keeps 0-d leaves 0-d
        if not a.flags.writeable:   # torch.from_numpy wants a writable
            a = a.copy()            # buffer (decoded blobs are read-only)
        if dtype == torch.bfloat16 and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device) if device is not None else t
