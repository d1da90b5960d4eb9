"""The plain reference of the fine stage with a TensoRF vector-matrix k0
(Chen et al., "TensoRF: Tensorial Radiance Fields", ECCV 2022), in
float32 PyTorch (TF32 off).  It imports nothing of the program.

The k0 parameters are the factors, named as the program names them:
planes ``xy_plane`` [X, Y, R], ``xz_plane`` [X, Z, R], ``yz_plane``
[Y, Z, R], vectors ``x_vec`` [X, R], ``y_vec`` [Y, R], ``z_vec`` [Z, R]
and the basis ``f_vec`` [3R, C], its rows in the order of the terms
below.  ``Stage.forward`` densifies them into the grid

    k0[x, y, z] = sum_r xy[x, y, r] z[z, r] B[r]
                + sum_r xz[x, z, r] y[y, r] B[R + r]
                + sum_r yz[y, z, r] x[x, r] B[2R + r]

as a dense k0 grid would hold it, and then runs the dense stage of
``sdf_step.Stage``, which serves it trilinearly: densify, then serve,
whatever route the program takes to the same numbers.  Each term is
contracted with the basis first ([A, B, R, C], small) and then with its
vector, one term at a time, so that no [X, Y, Z, R] tensor is made.
The control and the faults are the dense stage's.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import sdf_step

# (plane, vector, the contraction of the plane-with-basis and the vector
# into [X, Y, Z, C])
TERMS = (("xy_plane", "z_vec", "abrc,zr->abzc"),
         ("xz_plane", "y_vec", "abrc,yr->aybc"),
         ("yz_plane", "x_vec", "abrc,xr->xabc"))


def densify(k0: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The factors as a dense [X, Y, Z, C] grid (``C = 1``: the terms
    summed, where there is no basis)."""
    r0 = 0
    out = None
    for plane, vec, spec in TERMS:
        p, v = k0[plane], k0[vec]
        r = p.shape[-1]
        if "f_vec" in k0:
            pb = torch.einsum("abr,rc->abrc", p, k0["f_vec"][r0:r0 + r])
        else:
            pb = p[..., None]
        term = torch.einsum(spec, pb, v)
        out = term if out is None else out + term
        r0 += r
    return out


class Stage(sdf_step.Stage):
    """``sdf_step.Stage`` with a factored k0: ``p["k0"]`` is the factor
    dict, densified at every forward."""

    def forward(self, p, o, d, v, s_val):
        return super().forward(dict(p, k0=densify(p["k0"])), o, d, v, s_val)
