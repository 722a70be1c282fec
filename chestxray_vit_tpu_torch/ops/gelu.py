"""Exact-erf GELU with the same erf polynomial as the JAX package.

``erf_fast`` is the Abramowitz–Stegun 7.1.26 polynomial of
``chestxray_vit_tpu/ops/gelu.py``, written out term for term, so the port
and the reference agree to f32 rounding; ``torch.erf`` would differ from it
by up to 2.7e-6.
"""

from __future__ import annotations

from typing import Tuple

import torch

_LOG2E = 1.4426950408889634
_INV_SQRT2 = 0.7071067811865476


def erf_fast(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz–Stegun 7.1.26 erf, f32 math, sign-folded."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp2(-(ax * ax) * _LOG2E)
    return torch.sign(x) * y


def erf_gelu_factors(x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x/2, 1 + erf(x/√2)) in f32: the exact GELU is their product. The
    product's autograd node keeps both, so a backward that drops the GELU
    output (the ``mlp_hidden`` remat policies) rebuilds it from them."""
    xf = x.float()
    return xf * 0.5, 1.0 + erf_fast(xf * _INV_SQRT2)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """GELU with HF semantics: exact erf by default (via :func:`erf_fast`),
    tanh when ``approximate=True``. f32 internal math, output in x.dtype."""
    if approximate:
        return torch.nn.functional.gelu(x, approximate="tanh")
    half, cdf = erf_gelu_factors(x)
    return (half * cdf).to(x.dtype)
