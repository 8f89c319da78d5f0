"""Core: split-state transparent checkpoint/restart, ported to PyTorch.

Modules import what they need directly; this package module imports
nothing, so ``repro_torch.api.errors`` -> ``core.virtual_ids`` stays
free of import cycles.
"""
