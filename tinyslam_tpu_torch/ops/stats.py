"""Small reductions shared by the models and the kernels' plain versions."""

from __future__ import annotations

import torch


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median over ``dim`` ignoring NaN, with ``jnp.nanmedian``'s
    semantics: the mean of the two middle values for an even count, NaN
    where every value is NaN.  ``torch.sort`` puts NaN last."""
    s = torch.sort(x, dim=dim).values
    n = (~torch.isnan(x)).sum(dim, keepdim=True)
    lo = torch.div(n - 1, 2, rounding_mode="floor").clamp_min(0)
    hi = torch.div(n, 2, rounding_mode="floor")
    med = (s.gather(dim, lo) + s.gather(dim, hi)) * 0.5
    med = torch.where(n > 0, med, torch.full_like(med, float("nan")))
    return med.squeeze(dim)
