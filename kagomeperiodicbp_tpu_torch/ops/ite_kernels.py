"""Edge RDM and expectation values (the measurement half of
kagomeperiodicbp_tpu/ops/ite_kernels.py; the ITE half is not ported yet).

Leg conventions (the canonical EdgeTN layout):
* pair kets t1, t2: [d, e, x1, x2, x3] — physical, shared edge, then the 3
  environment legs counterclockwise;
* env: 6 tensors [prev, ket, bra, next] in ccw order starting from t1's
  first env leg.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _half(t: torch.Tensor, e0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Σ t[d,e,a,b,c]·conj(t)[D,E,x,y,z]·e0[p,a,x,q]·e1[q,b,y,r]·e2[r,c,z,s]
    → [d, D, e, E, p, s], contracted pairwise (peak d·D⁵·χ² elements)."""
    x = torch.einsum("deabc,paxq->debcpxq", t, e0)
    x = torch.einsum("debcpxq,qbyr->decpxyr", x, e1)
    x = torch.einsum("decpxyr,rczs->depxyzs", x, e2)
    return torch.einsum("depxyzs,DExyz->dDeEps", x, t.conj())


def rho_ij(t1: torch.Tensor, t2: torch.Tensor, env: Sequence[torch.Tensor]) -> torch.Tensor:
    """2-site RDM ρ[i_ket, i_bra, j_ket, j_bra], trace-normalised."""
    a_i = _half(t1, env[0], env[1], env[2])  # [i, I, e, E, p, s]
    a_j = _half(t2, env[3], env[4], env[5])  # [j, J, e, E, s, p]
    rho = torch.einsum("iIeEps,jJeEsp->iIjJ", a_i, a_j)
    return rho / torch.einsum("iijj->", rho)


def expectation(rho: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """⟨op⟩ = Σ ρ∘op with both in [i_ket, i_bra, j_ket, j_bra] layout."""
    return torch.einsum("iIjJ,iIjJ->", rho, op)
