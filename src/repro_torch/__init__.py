"""repro_torch — the transparent checkpoint/restart system ported to
PyTorch and CUDA (NVIDIA Hopper).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage names (``api``, ``configs``, ``core``, ``kernels``,
``models``, ``serving``) so each module has an obvious counterpart, and
writes the same checkpoint format (manifest format 3, keystr leaf
paths, dtype strings), so a checkpoint written by one package restores
in the other. It imports torch, numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""
