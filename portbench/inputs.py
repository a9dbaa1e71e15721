"""Inputs the benchmark makes itself and hands to both the program and the
reference: the Hamiltonian term and BP's uniform start messages."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def hamiltonian(name: str, dtype, device) -> torch.Tensor:
    """A two-site term h[i_ket, i_bra, j_ket, j_bra]. ``heisenberg_afm``:
    h = S·S = ¼ Σ_a σ_a ⊗ σ_a."""
    if name != "heisenberg_afm":
        raise ValueError(f"unknown hamiltonian {name!r}")
    x = torch.tensor([[0, 1], [1, 0]], dtype=torch.complex128)
    y = torch.tensor([[0, -1j], [1j, 0]], dtype=torch.complex128)
    z = torch.tensor([[1, 0], [0, -1]], dtype=torch.complex128)
    h = sum(torch.einsum("iI,jJ->iIjJ", s, s) for s in (x, y, z)) / 4
    return h.to(dtype=dtype, device=device)


def bond_profile(N: int, D: int, chi: int) -> List[int]:
    """A message's bonds as the port lays them out: bond k of its n = 2N−1
    sites is min(χ, (D²)^(k+1), (D²)^(n−1−k)), zero-padded."""
    n, p = 2 * N - 1, D * D
    return [min(chi, p ** (k + 1), p ** (n - 1 - k)) for k in range(n - 1)]


def uniform_messages(N: int, D: int, chi: int, dtype, device) -> Dict[int, Tuple[torch.Tensor, ...]]:
    """BP's "uniform" start: on every side, the product of vec(I_D)/√D with
    its bonds zero-padded to the profile. {side: sites [l, D², r]}."""
    prof = [1] + bond_profile(N, D, chi) + [1]
    v = (torch.eye(D, dtype=dtype, device=device) / D ** 0.5).reshape(D * D)
    sites = []
    for k in range(2 * N - 1):
        s = torch.zeros((prof[k], D * D, prof[k + 1]), dtype=dtype, device=device)
        s[0, :, 0] = v
        sites.append(s)
    return {side: tuple(s.clone() for s in sites) for side in range(6)}
