"""The reference's double-layer tensors, made from the kets, and the dense
form of a finished boundary MPS."""
from __future__ import annotations

from typing import List, Sequence

import torch



def fuse(ket: torch.Tensor) -> torch.Tensor:
    """ket [d, D,D,D,D] → its double-layer tensor [D², D², D², D²], each leg
    the pair (ket index, bra index), ket index major."""
    D = ket.shape[1]
    tt = torch.tensordot(ket, ket.conj(), dims=([0], [0]))
    return tt.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(D * D, D * D, D * D, D * D)


def fold_trivial(sites: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Fold the sites whose physical leg has dimension 1 (the message
    corners' dim-1 legs) into their neighbours."""
    sites = list(sites)
    i = 0
    while i < len(sites) and len(sites) > 1:
        s = sites[i]
        if s.shape[1] != 1:
            i += 1
            continue
        mat = s.reshape(s.shape[0], s.shape[2])
        if i + 1 < len(sites):
            sites[i + 1] = torch.tensordot(mat, sites[i + 1], dims=([1], [0]))
        else:
            sites[i - 1] = torch.tensordot(sites[i - 1], mat, dims=([2], [0]))
        del sites[i]
    return sites


def dense(sites: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full tensor over the physical legs of an MPS with trivial ends."""
    sites = fold_trivial(sites)
    t = sites[0]
    for s in sites[1:]:
        t = torch.tensordot(t, s, dims=([t.ndim - 1], [0]))
    return t.reshape(t.shape[1:-1])
