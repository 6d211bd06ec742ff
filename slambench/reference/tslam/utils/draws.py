"""The random draws of the RANSAC estimators, as an object passed down.

The JAX package draws with ``jax.random`` from keys it derives from frame
numbers; the port takes its draws from a ``Sampler`` that the caller owns
(``DeviceVO`` makes one and hands it to the bootstrap and to
``track_step``).

Each call names the reference's stream in ``key``: ``("two_view", seed,
"E" or "H")`` for the two-view estimate's samplers (the reference splits
``PRNGKey(seed)``, the bootstrap's seed being the frame number),
``("reloc", frame_idx)`` for the device tracker's relocalization
(``fold_in(PRNGKey(17), frame_idx)``, ``frame_idx`` a device tensor),
``("host_reloc", frame_idx)`` for ``VisualOdometry``'s (``PRNGKey(
frame_idx)``) and ``("loop", kf_id * 131 + old_id)`` for the loop probe's
PnP-RANSAC (``fold_in(PRNGKey(23), n)``).  A test's sampler can use the
key to replay the JAX streams.

The ``"reloc"`` and ``"loop"`` streams are keyed, as the reference's
are: their uniforms are a function of the sampler's seed, the stream and
the key's number alone (``keyed_uniform``), computed on the device the
number lies on from integer hashes, so the CPU and the card get the same
bits, nothing reads the number back, and a captured CUDA graph computes
each replay's own draws.  The seed, too, may be a device scalar
(``Sampler.keyed_on``): a captured graph reads it from its static
buffers, so that one graph serves every seed.  A frame's or a
candidate's draws do not depend
on what was drawn before them, and both attempts of one relocalization
draw the same uniforms, as the reference hands one key to both.  The
other streams (``"two_view"``, ``"host_reloc"``) draw in call order on
the CPU from the sampler's own ``torch.Generator`` (never the global one),
so the CPU and the card see the same numbers for the same sequence of
calls; for a CUDA target they are drawn into pinned memory and copied
without blocking, so drawing never synchronizes with the device.
"""

from __future__ import annotations

import copy

import torch

from slambench.reference.tslam.geometry.ransac import sample_indices

_M32 = 0xFFFFFFFF
RELOC_STREAM = 17           # the reference's PRNGKey(17) of the relocalization
LOOP_STREAM = 23            # the reference's PRNGKey(23) of the loop probe
_KEYED = {"reloc": RELOC_STREAM, "loop": LOOP_STREAM}


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32), a Python int or an int64
    tensor, in 16-bit halves so that no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit avalanche mixer (``lowbias32``) of a Python int or an int64
    tensor holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _word(x, dev: torch.device):
    """The low 32 bits of ``x``: of a host int as an int, of an integer
    tensor of one element as an int64 0-d tensor on ``dev``, read there
    and never on the host."""
    if isinstance(x, torch.Tensor):
        return x.to(dev).reshape(()).to(torch.int64) & _M32
    return int(x) & _M32


def keyed_uniform(seed, stream: int, n, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape`` on ``device`` that depend on
    (``seed``, ``stream``, ``n``) alone: element i is the top 24 bits of a
    hash of the key and i.  ``seed`` and ``n`` are each a host int or an
    integer tensor of one element on ``device``, read there and never on
    the host; a seed gives the same bits either way (its low 32 bits
    count)."""
    dev = torch.device(device)
    numel = 1
    for s in shape:
        numel *= int(s)
    key = _mix32(_mix32(_mul32(_word(seed, dev), 0x9E3779B1) ^ stream) ^ _mix32(_word(n, dev)))
    if not isinstance(key, torch.Tensor):
        key = torch.full((), key, dtype=torch.int64, device=dev)
    i = torch.arange(numel, dtype=torch.int64, device=dev)
    h = _mix32(key ^ _mix32(_mul32(i, 0x9E3779B1)))
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(tuple(shape))


def seed_word(sampler) -> int:
    """The 32 bits of ``sampler``'s seed that its keyed draws hash: what a
    captured graph's seed buffer holds for it."""
    return int(sampler.seed) & _M32


class Sampler:
    """Uniform draws: the ``"reloc"`` and ``"loop"`` streams keyed by
    (seed, number), the others from a seeded CPU generator in call order."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.generator = torch.Generator().manual_seed(self.seed)

    def keyed_on(self, seed: torch.Tensor) -> "Sampler":
        """A shallow copy whose keyed streams hash ``seed``, a 0-d integer
        tensor on the device (a captured graph's seed buffer), in place of
        this sampler's seed.  It shares this sampler's generator, so the
        call-order streams go on in order, and this sampler (whose state a
        checkpoint saves) is left as it was."""
        out = copy.copy(self)
        out.seed = seed
        return out

    def uniform(self, shape, device, key=None) -> torch.Tensor:
        """float32 uniforms in [0, 1) of ``shape`` on ``device``."""
        dev = torch.device(device)
        if key is not None and key[0] in _KEYED:
            return keyed_uniform(self.seed, _KEYED[key[0]], key[1], shape, dev)
        u = torch.rand(shape, generator=self.generator, pin_memory=dev.type == "cuda")
        return u.to(dev, non_blocking=True)

    def choice(self, valid: torch.Tensor, shape, key=None) -> torch.Tensor:
        """Indices (long, ``shape``) drawn uniformly among the true entries
        of ``valid`` (N,), on its device (the reference draws them with
        ``jax.random.categorical`` over the valid entries)."""
        return sample_indices(self.uniform(shape, valid.device, key), valid)
