"""Nister's 5-point minimal essential-matrix solver and its LO-RANSAC
(mirrors ``tinyslam_tpu/geometry/fivepoint.py``).

The ten cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) in
the null-space coordinates (x, y, z) are expanded with static monomial
multiplication tables, Gauss-Jordan reduced by a batched solve, and turned
into Nister's degree-10 polynomial in z, whose roots come from a fixed 100
Durand-Kerner iterations in complex arithmetic from the reference's start
values, so the roots, and the hypotheses with them, come in its order.
Each sample yields 10 candidate matrices; complex roots yield junk that
the RANSAC vote discards.  The module's docstring in the JAX package
derives B(z).
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference.tslam.geometry.epipolar import eight_point_essential, sampson_error
from slambench.reference.tslam.geometry.linalg import exact_null_space
from slambench.reference.tslam.geometry.ransac import lo_ransac, sample_indices

# Monomial orders.  deg<=1 (entries of E): [x, y, z, 1]
_E1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_E2 = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0), (0, 2, 0),
    (0, 1, 1), (0, 1, 0), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# deg<=3 (20): leading 10 then trailing 10 (Nister ordering)
_LEAD = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (2, 0, 0), (1, 2, 0),
    (1, 1, 1), (1, 1, 0), (0, 3, 0), (0, 2, 1), (0, 2, 0),
]
_TRAIL = [
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_E3 = _LEAD + _TRAIL
_I_X2Z, _I_X2 = 2, 3
_I_XYZ, _I_XY = 5, 6
_I_Y2Z, _I_Y2 = 8, 9


def _mul_table(a_order, b_order, out_order) -> np.ndarray:
    out_index = {m: i for i, m in enumerate(out_order)}
    T = np.zeros((len(a_order), len(b_order), len(out_order)), np.float32)
    for i, ma in enumerate(a_order):
        for j, mb in enumerate(b_order):
            m = tuple(x + y for x, y in zip(ma, mb))
            if m in out_index:
                T[i, j, out_index[m]] = 1.0
    return T


_T11 = _mul_table(_E1, _E1, _E2)   # (4, 4, 10)
_T21 = _mul_table(_E2, _E1, _E3)   # (10, 4, 20)


def _table(T: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(T, dtype=like.dtype, device=like.device)


def five_point_constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """basis (..., 4, 3, 3): [E1, E2, E3, E4] with E = x E1 + y E2 + z E3
    + E4.  Returns M (..., 10, 20) over the _E3 monomial order."""
    T11, T21 = _table(_T11, basis), _table(_T21, basis)
    Ec = torch.movedim(basis, -3, -1)                      # (..., 3, 3, 4)
    EEt = torch.einsum("...ack,...bcl,klm->...abm", Ec, Ec, T11)
    trace = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    C = 2.0 * torch.einsum("...ack,...cbl,klm->...abm", EEt, Ec, T21) \
        - torch.einsum("...k,...abl,klm->...abm", trace, Ec, T21)

    def p11(a, b):
        return torch.einsum("...i,...j,ijk->...k", a, b, T11)

    def p21(a, b):
        return torch.einsum("...i,...j,ijk->...k", a, b, T21)

    def minor(r1, r2, c1, c2):
        return p11(Ec[..., r1, c1, :], Ec[..., r2, c2, :]) - p11(
            Ec[..., r1, c2, :], Ec[..., r2, c1, :])

    det = (p21(minor(1, 2, 1, 2), Ec[..., 0, 0, :])
           - p21(minor(1, 2, 0, 2), Ec[..., 0, 1, :])
           + p21(minor(1, 2, 0, 1), Ec[..., 0, 2, :]))
    rows = [det] + [C[..., a, b, :] for a in range(3) for b in range(3)]
    return torch.stack(rows, dim=-2)


def _poly_mul(p, q):
    """Batched univariate product; coefficients in descending degree."""
    m, n = p.shape[-1], q.shape[-1]
    out = []
    for k in range(m + n - 1):
        terms = [p[..., i] * q[..., k - i]
                 for i in range(max(0, k - n + 1), min(m, k + 1))]
        out.append(sum(terms))
    return torch.stack(out, dim=-1)


def _poly_sub(p, q):
    """p - q, aligning the low-degree ends."""
    m = max(p.shape[-1], q.shape[-1])
    pad = torch.nn.functional.pad
    return pad(p, (m - p.shape[-1], 0)) - pad(q, (m - q.shape[-1], 0))


def nister_degree10(M: torch.Tensor):
    """M (..., 10, 20) -> (poly10 (..., 11) descending z-coefficients,
    (a (..., 2, 4), b (..., 2, 4), c (..., 2, 5)) for the x, y recovery)."""
    B = -torch.linalg.solve_ex(M[..., :10], M[..., 10:])[0]

    def split(r):
        return r[..., 0:3], r[..., 3:6], r[..., 6:10]

    def z_shift(p):
        return torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)

    rows_abc = []
    for i_m, i_mz in ((_I_X2, _I_X2Z), (_I_XY, _I_XYZ), (_I_Y2, _I_Y2Z)):
        am, bm, cm = split(B[..., i_m, :])
        az, bz, cz = split(B[..., i_mz, :])
        rows_abc.append((_poly_sub(z_shift(am), az), _poly_sub(z_shift(bm), bz),
                         _poly_sub(z_shift(cm), cz)))
    (a1, b1, c1), (a2, b2, c2), (a3, b3, c3) = rows_abc
    det = _poly_mul(a1, _poly_sub(_poly_mul(b2, c3), _poly_mul(b3, c2)))
    det = _poly_sub(det, _poly_mul(b1, _poly_sub(_poly_mul(a2, c3), _poly_mul(a3, c2))))
    det = _poly_sub(det, -_poly_mul(c1, _poly_sub(_poly_mul(a2, b3), _poly_mul(a3, b2))))
    poly10 = det[..., -11:]      # 12 coefficients allocated, true degree 10
    return poly10, (torch.stack([a1, a2], -2), torch.stack([b1, b2], -2),
                    torch.stack([c1, c2], -2))


def durand_kerner_roots(poly: torch.Tensor, iters: int = 100):
    """Roots of batched real polynomials poly (..., d+1) (descending) by
    simultaneous Weierstrass iteration after rescaling z = s w with
    s = max_k |a_k|^(1/k) of the monic coefficients.  Start: 1.5 x the
    roots of unity at angles 2 pi (k + 0.25) / d.  The complex arithmetic
    is spelled out in real operations in the reference's order, one
    rounding each, so the CPU and the card iterate alike.  A step that
    turns a root non-finite keeps the old one.  Returns (re, im), each
    (..., d)."""
    d = poly.shape[-1] - 1
    dt, dev = poly.dtype, poly.device
    lead = poly[..., 0:1]
    lead = torch.where(lead.abs() > 1e-12, lead, torch.full_like(lead, 1e-12))
    p = poly / lead
    ks = torch.arange(1, d + 1, dtype=dt, device=dev)
    s = torch.clamp((p[..., 1:].abs() ** (1.0 / ks)).amax(-1, keepdim=True), 1e-6, 1e6)
    p = p / s ** torch.arange(0, d + 1, dtype=dt, device=dev)
    angles = 2.0 * np.pi * (np.arange(d) + 0.25) / d
    shape = (*poly.shape[:-1], d)
    zr = (torch.as_tensor(np.cos(angles), dtype=dt, device=dev) * 1.5).expand(shape)
    zi = (torch.as_tensor(np.sin(angles), dtype=dt, device=dev) * 1.5).expand(shape)
    eye = torch.eye(d, dtype=dt, device=dev)
    diag = torch.eye(d, dtype=torch.bool, device=dev)
    for _ in range(iters):
        pr, pi = p[..., 0:1].expand(shape), torch.zeros_like(zr)
        for i in range(1, d + 1):                          # Horner
            pr, pi = pr * zr - pi * zi + p[..., i:i + 1], pr * zi + pi * zr
        dr = zr[..., :, None] - zr[..., None, :] + eye     # diagonal 1 + 0i
        di = torch.where(diag, 0.0, zi[..., :, None] - zi[..., None, :])
        qr, qi = torch.ones_like(zr), torch.zeros_like(zr)
        for j in range(d):                                 # prod over j != i
            ar, ai = dr[..., :, j], di[..., :, j]
            qr, qi = qr * ar - qi * ai, qr * ai + qi * ar
        den = qr * qr + qi * qi
        den = torch.where(den > 1e-30, den, torch.full_like(den, 1e-30))
        zr2 = zr - (pr * qr + pi * qi) / den
        zi2 = zi - (pi * qr - pr * qi) / den
        ok = torch.isfinite(zr2) & torch.isfinite(zi2)
        zr, zi = torch.where(ok, zr2, zr), torch.where(ok, zi2, zi)
    return zr * s, zi * s


def five_point_essential(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Minimal 5-point solve: x1, x2 (..., 5, 2) normalized.  Returns
    (..., 10, 3, 3) unit-Frobenius candidates; those of non-real roots are
    filled with 1e6 before the normalization (junk that scores out)."""
    h1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    h2 = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    A = (h2[..., :, None] * h1[..., None, :]).reshape(*h1.shape[:-2], 5, 9)
    vecs = exact_null_space(A, 4)                          # (..., 9, 4)
    basis = vecs.transpose(-1, -2).reshape(*A.shape[:-2], 4, 3, 3)
    poly10, (Ar, Br, Cr) = nister_degree10(five_point_constraint_matrix(basis))
    zr, zi = durand_kerner_roots(poly10)
    real = zi.abs() < 1e-4 * (1.0 + zr.abs())

    def eval_poly(c, z):
        # c (..., 2, n), z (..., 10) -> (..., 10, 2)
        out = c[..., None, :, 0].expand(*z.shape, 2)
        for i in range(1, c.shape[-1]):
            out = out * z[..., None] + c[..., None, :, i]
        return out

    av, bv, cv = eval_poly(Ar, zr), eval_poly(Br, zr), eval_poly(Cr, zr)
    det = av[..., 0] * bv[..., 1] - av[..., 1] * bv[..., 0]
    det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    xs = (-cv[..., 0] * bv[..., 1] + cv[..., 1] * bv[..., 0]) / det
    ys = (-av[..., 0] * cv[..., 1] + av[..., 1] * cv[..., 0]) / det
    E = (xs[..., None, None] * basis[..., None, 0, :, :]
         + ys[..., None, None] * basis[..., None, 1, :, :]
         + zr[..., None, None] * basis[..., None, 2, :, :]
         + basis[..., None, 3, :, :])
    E = torch.where(real[..., None, None], E, torch.full_like(E, 1e6))
    norm = torch.linalg.norm(E, dim=(-2, -1), keepdim=True)
    return E / torch.clamp_min(norm, 1e-12)


def ransac_essential_5pt(u: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                         valid: torch.Tensor, inlier_threshold: float = 2e-3,
                         refine_iters: int = 2, lo_candidates: int = 16) -> dict:
    """LO-RANSAC with the 5-point solver: each sample contributes its 10
    roots as hypotheses.  ``u`` (S, 5) uniforms in [0, 1) draw the samples
    (the reference draws ``jax.random.uniform(key, (S, 5))``).  Returns
    dict with E (3, 3), inliers (N,), num_inliers ()."""
    thresh2 = inlier_threshold * inlier_threshold
    idx = sample_indices(u, valid)
    E = five_point_essential(x1[idx], x2[idx]).reshape(-1, 3, 3)
    n = x1.shape[0]
    E_best, inliers, num = lo_ransac(
        E, lambda m: sampson_error(m, x1[None], x2[None]),
        lambda w: eight_point_essential(x1.expand(w.shape[0], n, 2),
                                        x2.expand(w.shape[0], n, 2), w),
        valid, thresh2, 16.0 * thresh2, refine_iters, lo_candidates)
    return {"E": E_best, "inliers": inliers, "num_inliers": num}
