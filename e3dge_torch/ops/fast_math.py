"""Range-reduced polynomial sine — counterpart of `e3dge_tpu/ops/fast_math.py`.

It belongs to the field kernel's `serving` precision: `csrc/siren_field.cu`
evaluates the same reduction and the same degree-11 odd polynomial (constants
copied from the JAX module), and this plain version is what the kernel is held
against. Max abs error 9.6e-8 on [-pi, pi], plus ~|x|*2^-24 from the reduction.
"""

from __future__ import annotations

import torch

_INV_2PI = 0.15915494309189535
_2PI = 6.283185307179586

# degree-11 odd polynomial sin(x) = x * P(x^2) on [-pi, pi]
_S = (
    9.9999959991e-01,
    -1.6666552631e-01,
    8.3324029612e-03,
    -1.9808632629e-04,
    2.6997138342e-06,
    -2.0362212395e-08,
)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) in f32 via x - round(x/2pi)*2pi and the odd polynomial; returns the
    input dtype. `torch.round` rounds half to even like `jnp.round` (the kernel
    uses `rintf`)."""
    dt = x.dtype
    x = x.float()
    x = x - torch.round(x * _INV_2PI) * _2PI
    x2 = x * x
    p = torch.full_like(x, _S[5])
    for c in (_S[4], _S[3], _S[2], _S[1], _S[0]):
        p = p * x2 + c
    return (x * p).to(dt)
