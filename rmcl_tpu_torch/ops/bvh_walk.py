"""The input checks that the two BVH walks share: the exact cast (K5,
:mod:`rmcl_tpu_torch.ops.traverse_cuda`) and the closest-point walk (K6,
:mod:`rmcl_tpu_torch.ops.closest_cuda`)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def check_slots(nodes: Tensor, root_link: Tensor):
    if nodes.dtype != torch.float32 or nodes.dim() != 2 or nodes.shape[1] != 16:
        raise ValueError(f"nodes must be (N, 16) float32, got {tuple(nodes.shape)} {nodes.dtype}")
    if not nodes.is_contiguous():
        raise ValueError("nodes must be contiguous")
    if root_link.dtype != torch.int32 or root_link.dim() != 0:
        raise ValueError("root_link must be a 0-dim int32 tensor")
    if root_link.device != nodes.device:
        raise ValueError(f"root_link is on {root_link.device}, nodes on {nodes.device}")
    if nodes.device.type == "cuda" and nodes.data_ptr() % 16:
        raise ValueError("nodes must start on a 16-byte boundary (the kernel reads a slot as "
                         "four 16-byte loads): pass a fresh tensor, not an offset view")


def check_rows(dev, **tensors):
    """Each ``name=(tensor, dtype, shape)`` on ``dev``, contiguous."""
    for name, (x, dtype, shape) in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, nodes on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
