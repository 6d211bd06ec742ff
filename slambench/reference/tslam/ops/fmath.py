"""float32 ``atan2``, ``sin`` and ``cos`` that round as the C library's
``atan2f``, ``sinf`` and ``cosf`` do, and a float32 fused multiply-add.

The JAX package's CPU backend calls glibc's ``atan2f``, ``sinf`` and
``cosf`` and contracts a product and a sum into one FMA.  ``torch.atan2``,
``torch.sin`` and ``torch.cos`` round differently (SLEEF on the CPU, CUDA's
own on the card): ``torch.atan2`` differs from ``atan2f`` in the last bit
of about one result in six, and it differs between the CPU and the card.
So orientations, and the BRIEF bits that they steer, would differ between
the port's CPU path, its CUDA path and the reference.

These functions evaluate the C library's algorithms (glibc 2.36: fdlibm's
``atan2f``/``atanf`` in float32, ``sinf``/``cosf`` by a float64 polynomial
after a float64 quadrant reduction) with basic IEEE operations, each one a
separate PyTorch kernel that rounds once, so they give the same bits on
the CPU and the card.  Inputs are finite; ``sincosf`` takes
|x| < 120 (the C library's fast-reduction range), which covers the angles
that ``atan2f`` returns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# fdlibm s_atanf.c / e_atan2f.c constants, by their bit patterns.
_ATAN_HI = [_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)]
_ATAN_LO = [_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)]
_AT = [_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E,
                         0xBD9D8795, 0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
                         0x3C8569D7)]
_PI = _f32(0x40490FDB)
_PI_LO = _f32(0xB3BBBD2E)
_PI_O_2 = _f32(0x3FC90FDB)

# glibc's __sincosf_table[0] (s_sincosf_data.c); table 1 negates c0-c4.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")           # pi/2
_C = [float.fromhex(v) for v in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                 "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_S = [float.fromhex(v) for v in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                 "-0x1.994eb3774cf24p-13")]


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (tensors, or numbers that are
    float32 values): the float64 product of two float32 values is exact,
    and the sum's float64 rounding moves the float32 result only at an
    exact float32 midpoint (about 2^-29 of the time)."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else float(v) for v in (a, b, c))
    return (a * b + c).float()


@functools.lru_cache(maxsize=8)
def _atan_table(device: torch.device) -> torch.Tensor:
    """(2, 4) ``atanhi``, ``atanlo`` on ``device``, uploaded once: a copy
    from host memory on every call would synchronize with the card."""
    return torch.tensor([_ATAN_HI, _ATAN_LO], dtype=torch.float32, device=device)


def _atanf_nonneg(t: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of float32 t >= 0."""
    small = t < 0.4375
    x = torch.where(small, t, -1.0 / t)                     # id 3: t >= 2.4375
    x = torch.where((t >= 1.1875) & (t < 2.4375), (t - 1.5) / (1.0 + 1.5 * t), x)
    x = torch.where((t >= 0.6875) & (t < 1.1875), (t - 1.0) / (t + 1.0), x)
    x = torch.where((t >= 0.4375) & (t < 0.6875), (2.0 * t - 1.0) / (2.0 + t), x)
    idx = ((t >= 0.6875).int() + (t >= 1.1875).int() + (t >= 2.4375).int()).long()
    z = x * x
    w = z * z
    s1 = z * (_AT[0] + w * (_AT[2] + w * (_AT[4] + w * (_AT[6] + w * (_AT[8] + w * _AT[10])))))
    s2 = w * (_AT[1] + w * (_AT[3] + w * (_AT[5] + w * (_AT[7] + w * _AT[9]))))
    hi, lo = _atan_table(t.device)[:, idx]
    r = torch.where(small, x - x * (s1 + s2), hi - ((x * (s1 + s2) - lo) - x))
    r = torch.where(t < 2.0**-29, t, r)
    return torch.where(t >= 2.0**25, torch.full_like(t, _ATAN_HI[3] + _ATAN_LO[3]), r)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2(y, x), the bits of glibc's ``atan2f``."""
    y, x = torch.broadcast_tensors(y.float(), x.float())
    iy = y.view(torch.int32) & 0x7FFFFFFF
    ix = x.view(torch.int32) & 0x7FFFFFFF
    neg_y, neg_x = torch.signbit(y), torch.signbit(x)
    k = (iy - ix) >> 23
    safe_x = torch.where(ix == 0, torch.ones_like(x), x)
    z = _atanf_nonneg(torch.abs(y / safe_x))
    z = torch.where(neg_x & (k < -60), torch.zeros_like(z), z)
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2 + 0.5 * _PI_LO), z)
    r = torch.where(neg_x, torch.where(neg_y, (z - _PI_LO) - _PI, _PI - (z - _PI_LO)),
                    torch.where(neg_y, -z, z))
    half = torch.where(neg_y, -_PI_O_2, _PI_O_2)
    r = torch.where(ix == 0, half, r)
    at_zero = torch.where(neg_x, torch.where(neg_y, -_PI, _PI), y)
    return torch.where(iy == 0, at_zero, r)


def _sincos_poly(x: torch.Tensor, x2: torch.Tensor, c: list, cos: torch.Tensor):
    """glibc's ``sinf_poly`` in float64: the cosine polynomial where ``cos``,
    else the sine polynomial; ``c`` holds c0-c4 (tensors or floats)."""
    x3 = x * x2
    sin = (x + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    x4 = x2 * x2
    cosv = ((c[0] + x2 * c[1]) + x4 * c[2]) + (x4 * x2) * (c[3] + x2 * c[4])
    return torch.where(cos, cosv, sin)


def sincosf(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin a, cos a) in float32, the bits of glibc's ``sinf`` and ``cosf``
    for |a| < 120."""
    a = a.float()
    x = a.double()
    mag = a.abs()
    # Quadrant n by the scaled integer conversion of glibc's reduce_fast.
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = x - n.double() * _HPI
    sign = torch.where((n & 3) == 1, -1.0, 1.0) * torch.where((n & 3) == 2, -1.0, 1.0)
    flip = torch.where((n & 2) != 0, -1.0, 1.0).double()
    c = [flip * v for v in _C]
    odd = (n & 1) != 0
    big_s = _sincos_poly(xr * sign, xr * xr, c, odd)
    big_c = _sincos_poly(xr * sign, xr * xr, c, ~odd)
    small = mag < 0.75                   # abstop12(a) < abstop12(pi/4)
    yes, no = torch.ones_like(small), torch.zeros_like(small)
    s = torch.where(small, _sincos_poly(x, x * x, _C, no), big_s).float()
    co = torch.where(small, _sincos_poly(x, x * x, _C, yes), big_c).float()
    tiny = mag < 2.0**-12
    return torch.where(tiny, a, s), torch.where(tiny, torch.ones_like(a), co)
