"""Double-float (two-f32, "double-word") arithmetic for the outer residual
(twin of ``openmg_tpu/ops/doublefloat.py``).

The defect-correction residual ``r = b − A x`` is evaluated in
**double-float** arithmetic — each value is an unevaluated sum ``hi + lo``
of two float32s (~49-bit effective mantissa, unit roundoff ~2⁻⁴⁹) — using
the classical error-free transformations (Knuth TwoSum, Dekker
QuickTwoSum).  All operations are elementwise f32 tensor code; no float64
touches the device.

PyTorch's eager elementwise operators neither reassociate nor contract, so
every line below rounds exactly where it is written.  The hand-written
kernel of :mod:`openmg_tpu_torch.ops.kernels` repeats the same sequences
with ``__fadd_rn`` / ``__fmul_rn``.

Ported: ``two_sum``, ``quick_two_sum``, ``df_add``, ``df_add_f32``,
``df_neg``, ``df_sub``, the Dekker products ``two_prod`` / ``df_mul`` /
``df_mul_f32`` (the residual of an operator whose taps are not dyadic) and
the host-side ``pow2_terms`` / ``df_split`` / ``df_merge``.

The products rely on ``a*b − p`` NOT being contracted into a fused
multiply-add, which eager PyTorch guarantees (one kernel per operation);
do not wrap them in ``torch.compile``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "pow2_terms",
    "df_split",
    "df_merge",
    "two_sum",
    "quick_two_sum",
    "df_add",
    "df_add_f32",
    "df_sub",
    "df_neg",
    "two_prod",
    "df_mul",
    "df_mul_f32",
]

# Dekker/Veltkamp splitter for a 24-bit mantissa: 2^12 + 1
_SPLIT = 4097.0


def pow2_terms(v, max_terms: int = 3):
    """Decompose ``v`` into a sum of ≤ ``max_terms`` signed powers of two,
    or None.  A power-of-two factor makes ``p·x`` *exact* in f32 (no
    mantissa bits added), so a double-float multiply by such a ``v``
    degenerates to exact scalings + compensated adds — the basis of the
    residual for Poisson-family stencils, whose taps are all of this form
    (±1 and 2d = 2, 4, 4+2)."""
    r = float(v)
    if r != np.float64(np.float32(r)):
        return None  # not exactly representable
    out = []
    for _ in range(max_terms):
        if r == 0.0:
            return tuple(out)
        a = math.copysign(2.0 ** math.floor(math.log2(abs(r))), r)
        out.append(a)
        r -= a
    return tuple(out) if r == 0.0 else None


def df_split(a, device="cpu") -> tuple:
    """Host-side split of a float64 array into an exact (hi, lo) f32 pair,
    placed on ``device``."""
    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return (
        torch.from_numpy(np.ascontiguousarray(hi)).to(device),
        torch.from_numpy(np.ascontiguousarray(lo)).to(device),
    )


def df_merge(x) -> np.ndarray:
    """Host-side merge back to float64 (the sum is formed on the host: the
    device never sees a float64)."""
    hi, lo = x
    return hi.detach().cpu().numpy().astype(np.float64) + lo.detach().cpu(
    ).numpy().astype(np.float64)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split32(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker split)."""
    p = a * b
    a_hi, a_lo = _split32(a)
    b_hi, b_lo = _split32(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x, y):
    """Double-float + double-float."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def df_add_f32(x, a):
    """Double-float + plain f32."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return quick_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    """Double-float × double-float."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def df_mul_f32(x, a):
    """Double-float × plain f32."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return quick_two_sum(p, e)
