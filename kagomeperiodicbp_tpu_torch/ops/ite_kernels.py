"""ITE numeric kernels (counterpart of kagomeperiodicbp_tpu/ops/ite_kernels.py):
the 2-site RDM, the Lubasch reduced environment, the ALS truncation of the
shared bond and the gate application. Shapes stay those of the JAX package
(eigenvalue clipping zeroes columns instead of slicing).

Leg conventions (the canonical EdgeTN layout):
* pair kets t1, t2: [d, e, x1, x2, x3] — physical, shared edge, then the 3
  environment legs counterclockwise;
* env: 6 tensors [prev, ket, bra, next] in ccw order starting from t1's
  first env leg.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .linalg import eigh_psd_sqrt, pinv_reg, qr_stable, robust_solve


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


# ----------------------------- reduced env --------------------------------


def _qr_reduce(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split t[d, e, rest...] = a[d, e, r] · t_rest[r, rest...] by a QR of
    the tall [rest, d·e] matrix (CholeskyQR2 on K2 under KPBP_LINALG=gram)."""
    d, e = t.shape[0], t.shape[1]
    rest_shape = tuple(t.shape[2:])
    q, r = qr_stable(t.reshape(d * e, -1).T)
    a = r.T.reshape(d, e, r.shape[0])
    t_rest = q.T.reshape((q.shape[1],) + rest_shape)
    return a, t_rest


def _half_env(t_rest: torch.Tensor, env_sites: Sequence[torch.Tensor]) -> torch.Tensor:
    """N_half[r, r*, up, down]: t_rest and its conjugate sandwiched with
    their 3 env sites, unit Frobenius norm; `up` is the env bond entering
    the first site, `down` the bond leaving the last. Contracted pairwise."""
    e0, e1, e2 = env_sites
    x = torch.einsum("tabc,paxq->tbcpxq", t_rest, e0)
    x = torch.einsum("tbcpxq,qbym->tcpxym", x, e1)
    x = torch.einsum("tcpxym,mczs->tpxyzs", x, e2)
    n = torch.einsum("tpxyzs,Txyz->tTps", x, t_rest.conj())
    return n / torch.linalg.vector_norm(n)


def reduced_env(t1: torch.Tensor, t2: torch.Tensor, env: Sequence[torch.Tensor]):
    """Lubasch reduced environment: (X, a1, a2, t1_rest, t2_rest, w) with
    N_red ≈ X·X†, t_i = a_i · t_i_rest, X [r1, r2, x], a_i [d, e, r_i], and
    w the eigenvalues of the raw N_red. The gauge of each reduced leg is
    fixed by a QR of X, whose factor goes into a_i and its inverse into X
    and t_i_rest."""
    a1, t1_rest = _qr_reduce(t1)
    a2, t2_rest = _qr_reduce(t2)

    n1 = _half_env(t1_rest, env[0:3])   # [r1, r1*, p, s]
    n2 = _half_env(t2_rest, env[3:6])   # [r2, r2*, s, p]
    nred = torch.einsum("rRps,qQsp->rqRQ", n1, n2)
    r1, r2 = nred.shape[0], nred.shape[1]
    x, w = eigh_psd_sqrt(nred.reshape(r1 * r2, r1 * r2))
    x = x.reshape(r1, r2, x.shape[1])   # [r1, r2, xdim]

    _, ri = qr_stable(x.reshape(r1, -1).T)
    li = ri.T                           # [r1, r1']
    li_inv = pinv_reg(li)
    _, rj = qr_stable(x.permute(0, 2, 1).reshape(-1, r2))
    rj_inv = pinv_reg(rj)               # rj: [r2', r2]

    x = torch.tensordot(li_inv, x, dims=([1], [0]))              # [r1', r2, xdim]
    t1_rest = torch.tensordot(li_inv, t1_rest, dims=([1], [0]))
    a1 = torch.tensordot(a1, li, dims=([2], [0]))                # [d, e, r1']

    # As in the JAX package, X's r2 leg takes rj⁻ᵀ, where rj⁻¹ would keep
    # a2·X unchanged; with rj⁻ᵀ the update depends on the phase gauge of the
    # shared bond. Kept for parity with the reference (ROADMAP queue 3).
    x = torch.tensordot(x, rj_inv.T, dims=([1], [0])).permute(0, 2, 1)  # [r1', r2', xdim]
    t2_rest = torch.tensordot(rj_inv.T, t2_rest, dims=([1], [0]))
    a2 = torch.tensordot(a2, rj.T, dims=([2], [0]))              # [d, e, r2']
    return x, a1, a2, t1_rest, t2_rest, w


# ----------------------------- ALS truncation -----------------------------


def _local_env(a_other: torch.Tensor, a_other_bra: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """N_i[d,e,r; d*,e*,r*] with the identity on the physical leg."""
    ket = torch.einsum("dEr,arx->dEax", a_other, x)
    bra = torch.einsum("dEr,arx->dEax", a_other_bra, x)
    n = torch.einsum("dEax,dFbx->EaFb", ket, bra.conj())
    eye = torch.eye(a_other.shape[0], dtype=a_other.dtype, device=a_other.device)
    return torch.einsum("pq,EaFb->pEaqFb", eye, n)


def truncation_distance(ea1, ea2, na1, na2, x) -> torch.Tensor:
    """‖ψ_exact − ψ_new‖², normalised by (‖ψ_exact‖² + ‖ψ_new‖²)/2."""

    def ip(b1, b2, k1, k2):
        ket = torch.einsum("fes,desx->fdx", k2, torch.einsum("der,rsx->desx", k1, x))
        bra = torch.einsum("fes,desx->fdx", b2, torch.einsum("der,rsx->desx", b1, x))
        return torch.einsum("fdx,fdx->", ket, bra.conj())

    ip1 = ip(ea1, ea2, ea1, ea2)
    ip2 = ip(na1, na2, na1, na2)
    ip3 = ip(na1, na2, ea1, ea2)
    return (2 * (ip1 + ip2 - 2 * ip3) / (ip1 + ip2)).real


def _swap_x(x: torch.Tensor) -> torch.Tensor:
    return x.permute(1, 0, 2)


def _als_solve(exact_a: torch.Tensor, new_other: torch.Tensor, exact_other: torch.Tensor,
               x: torch.Tensor, shape) -> torch.Tensor:
    """One ALS half-step: the a that best matches exact_a·exact_other with
    new_other held fixed, from the spectral pseudo-solve of its normal
    equations."""
    n = _local_env(new_other, new_other, x)
    m = n.shape[0] * n.shape[1] * n.shape[2]
    b = torch.einsum("pEaqFb,pEa->qFb", _local_env(exact_other, new_other, x), exact_a)
    return robust_solve(n.reshape(m, m).T, b.reshape(-1)).reshape(shape)


def als_optimize(d_max: int, exact_a1: torch.Tensor, exact_a2: torch.Tensor, x: torch.Tensor,
                 n_iter: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternating-least-squares truncation of the shared bond to d_max:
    n_iter sweeps (no early exit, as in the JAX package), each solving for
    a1, then a2, then fixing the gauge by QR/LQ and an SVD of the middle."""
    d = exact_a1.shape[0]
    r1, r2 = exact_a1.shape[2], exact_a2.shape[2]
    new_a1 = exact_a1[:, :d_max, :]
    new_a2 = exact_a2[:, :d_max, :]
    xs = _swap_x(x)
    for _ in range(n_iter):
        new_a1 = _als_solve(exact_a1, new_a2, exact_a2, x, new_a1.shape)
        new_a2 = _als_solve(exact_a2, new_a1, exact_a1, xs, new_a2.shape)

        q1, r1m = qr_stable(new_a1.permute(0, 2, 1).reshape(d * r1, d_max))
        q2, r2m = qr_stable(new_a2.permute(1, 0, 2).reshape(d_max, d * r2).T)
        u, s, vh = torch.linalg.svd(r1m @ r2m.T, full_matrices=False)
        sq = torch.sqrt(s).to(q1.dtype)
        left = (q1 @ u) * sq[None, :]
        right = (sq[:, None] * vh) @ q2.T
        new_a1 = left.reshape(d, r1, d_max).permute(0, 2, 1)
        new_a2 = right.reshape(d_max, d, r2).permute(1, 0, 2)
    return (new_a1 / torch.linalg.vector_norm(new_a1),
            new_a2 / torch.linalg.vector_norm(new_a2))


# --------------------------- gate application -----------------------------


def gate_from_hamiltonian(h: torch.Tensor, dt) -> torch.Tensor:
    """g = exp(−dt·h) in the [i_ket, i_bra, j_ket, j_bra] layout of h."""
    d = h.shape[0]
    m = h.permute(0, 2, 1, 3).reshape(d * d, d * d)
    g = torch.linalg.matrix_exp(-dt * m)
    return g.reshape(d, d, d, d).permute(0, 2, 1, 3)


def apply_gate(g: Optional[torch.Tensor], d_max: int, t1: torch.Tensor, t2: torch.Tensor,
               env: Sequence[torch.Tensor], als_iters: int = 10):
    """Apply a 2-local gate to the pair and ALS-truncate the shared bond to
    d_max. Returns (t1', t2', eigenvalues of the raw reduced environment);
    t1', t2' are scaled to unit max-abs and fixed up to a phase per value of
    the shared leg."""
    x, a1, a2, t1_rest, t2_rest, w = reduced_env(t1, t2, env)
    d = a1.shape[0]
    r1, r2 = a1.shape[2], a2.shape[2]
    if g is None:
        theta = torch.einsum("Ier,Jes->IrJs", a1, a2)
    else:
        theta = torch.einsum("iIjJ,IrJs->irjs", g, torch.einsum("Ier,Jes->IrJs", a1, a2))
    u, s, vh = torch.linalg.svd(theta.reshape(d * r1, d * r2), full_matrices=False)
    sq = torch.sqrt(s).to(u.dtype)
    ea1 = (u * sq[None, :]).reshape(d, r1, -1).permute(0, 2, 1)    # [d, Dp, r1]
    ea2 = (sq[:, None] * vh).reshape(-1, d, r2).permute(1, 0, 2)   # [d, Dp, r2]

    new_a1, new_a2 = als_optimize(d_max, ea1, ea2, x, n_iter=als_iters)
    t1_new = torch.tensordot(new_a1, t1_rest, dims=([2], [0]))
    t2_new = torch.tensordot(new_a2, t2_rest, dims=([2], [0]))
    return t1_new / t1_new.abs().max(), t2_new / t2_new.abs().max(), w
