"""Feature container and descriptor bit packing.

Mirrors ``tinyslam_tpu/types.py``: a fixed-capacity struct of tensors with
a valid mask.  Descriptors are ``(N, 8)`` 32-bit words holding bit
``w*32 + i`` in bit ``i`` of word ``w``.  They are stored as ``torch.int32``
with the same bits as the JAX package's ``uint32`` (torch's CPU ``uint32``
has no shifts); they cross to and from numpy as ``.view(np.int32)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Features:
    """A fixed-capacity batch of ORB features.

    xy (N, 2) float32 level-0 pixels; level (N,) int32; angle (N,) float32;
    score (N,) float32; desc (N, 8) int32 packed bits; valid (N,) bool.
    Any leading batch dimension is allowed (window slots, keyframe ring).
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1, dtype=torch.int32)

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "Features":
        """Apply ``fn`` to every field."""
        return Features(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})

    @staticmethod
    def empty(capacity: int, device=None) -> "Features":
        return Features(
            xy=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
            level=torch.zeros((capacity,), dtype=torch.int32, device=device),
            angle=torch.zeros((capacity,), dtype=torch.float32, device=device),
            score=torch.zeros((capacity,), dtype=torch.float32, device=device),
            desc=torch.zeros((capacity, 8), dtype=torch.int32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @staticmethod
    def concatenate(parts: list["Features"]) -> "Features":
        return Features(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts], dim=0)
            for f in dataclasses.fields(Features)})

    @staticmethod
    def from_numpy(d: dict, device=None, prefix: str = "") -> "Features":
        """Build from a flat dict of numpy arrays keyed ``prefix + field``."""
        return Features(**{
            f.name: from_numpy(d[prefix + f.name], device)
            for f in dataclasses.fields(Features)})

    def to_numpy(self, prefix: str = "") -> dict:
        """Flat dict of numpy arrays; descriptors come back as ``uint32``."""
        return {prefix + f.name: to_numpy(getattr(self, f.name),
                                          desc=f.name == "desc")
                for f in dataclasses.fields(self)}


def from_numpy(a, device=None) -> torch.Tensor:
    """numpy -> tensor; ``uint32`` (descriptors) is re-viewed as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)   # a contiguous copy


def to_numpy(x: torch.Tensor, desc: bool = False) -> np.ndarray:
    """tensor -> numpy; with ``desc`` the int32 words go back to ``uint32``."""
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if desc else a


def unpack_descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) packed int32 -> (..., 256) {0,1} int8 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.int8)


def pack_descriptor_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32 packed (bit w*32+i -> word w bit i).
    The bits of one word are disjoint, so their int32 sum is their OR."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(-1, dtype=torch.int32)


def descriptor_signs(desc: torch.Tensor) -> torch.Tensor:
    """(..., 8) packed -> (..., 256) int8 in {-1, +1}."""
    return unpack_descriptor_bits(desc) * 2 - 1
