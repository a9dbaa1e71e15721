"""The reference for an ITE edge update, in two stages.

1. The environment: the pair's two-site density matrix from the cell's kets
   and the incoming messages, by the reference's own contraction of the two
   halves of the network on either side of the pair's row, then that row
   exactly. The program's environment gives its own density matrix by
   ``rho_ij``; the two are compared.
2. Gate and truncation: from the environment the program used (captured in
   the timed update), the reduced environment, the gate and the ALS
   truncation, worked out again in plain torch from the JAX package's
   equations (``kagomeperiodicbp_tpu/ops/ite_kernels.py``, the reference
   repo's ``ITE.py``) with the thresholds of the configuration's dtype; the
   truncated pair that comes out is compared with the pair the program wrote
   back into its cell. This stage starts from the program's environment,
   which stage 1 checks by itself.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from .contract import fuse
from .executor import Recipe, run_plan
from .geometry.edge import EDGE_DIRECTION, cut_geometry, edge_pair
from .geometry.kagome import KagomeBlock
from .numerics import Precision, eigh_psd_sqrt, psd_solve, qr_pos, real_dtype


@functools.lru_cache(maxsize=None)
def _geometry(N: int, D: int, chi: int, chi_msg: int, first: int, second: int):
    return (cut_geometry(N, D, chi, chi_msg, EDGE_DIRECTION[(first, second)]),
            edge_pair(KagomeBlock.build(N), first, second))


def _row_sites(sites, site_of, chain):
    """The frontier's site of each chain node: the row's frontier holds one
    site per chain node and nothing else."""
    if len(sites) != len(chain):
        raise AssertionError("the row's frontier holds sites of no chain node")
    return {v: sites[site_of[v]] for v in chain}


def _flip(site):
    return site.permute(2, 1, 0)


def _walk_fused(T, top, bot, t):
    """One closed node of the row: T[t, c, b] with the top site [t, pt, t'],
    the node [pt, c, pb, c'] and the bottom site [b', pb, b] → T'[t', c', b']."""
    x = torch.tensordot(T, top, dims=([0], [0]))               # [c, b, pt, t']
    x = torch.tensordot(x, t, dims=([2, 0], [0, 1]))           # [b, t', pb, c']
    return torch.tensordot(x, bot, dims=([2, 0], [1, 2]))     # [t', c', b']


def _walk_open(T, top, bot, ket, D):
    """The pair's node, ket and bra apart with the physical legs left open:
    T[t, c, b], ket [i, pt, c, pb, c'] → T'[t', c', b', i, i'] (fused legs
    are (ket, bra) pairs, ket major)."""
    t_, c_, b_ = T.shape
    T = T.reshape(t_, D, D, b_)                                 # [t, ck, cb, b]
    top = top.reshape(top.shape[0], D, D, top.shape[2])         # [t, pk, pb, t']
    bot = bot.reshape(bot.shape[0], D, D, bot.shape[2])         # [b', qk, qb, b]
    x = torch.tensordot(T, top, dims=([0], [0]))                # [ck, cb, b, pk, pb, t']
    x = torch.tensordot(x, ket, dims=([3, 0], [1, 2]))          # [cb, b, pb, t', i, qk, ok]
    x = torch.tensordot(x, ket.conj(), dims=([2, 0], [1, 2]))   # [b, t', i, qk, ok, I, qb, ob]
    x = torch.tensordot(x, bot, dims=([0, 3, 6], [3, 1, 2]))    # [t', i, ok, I, ob, b']
    x = x.permute(0, 2, 4, 5, 1, 3)                             # [t', ok, ob, b', i, I]
    s = x.shape
    return x.reshape(s[0], s[1] * s[2], s[3], s[4], s[5])


def pair_rho(kets: Sequence[torch.Tensor], msg_sites, N: int, chi: int, chi_msg: int,
             first: int, second: int, prec: Precision, recipe: Recipe) -> torch.Tensor:
    """ρ[i_ket, i_bra, j_ket, j_bra] of the pair (n1 of flavor `first`, n2
    of `second`), trace one: the two halves of the network on either side of
    the pair's row as boundary MPSs (single-layer where the program's
    double-layer blob would pass its limit, as algo/edge_env decides), then
    the row, walked in from both ends to the pair."""
    D = kets[0].shape[1]
    geo, (n1, n2) = _geometry(N, D, chi, chi_msg, first, second)
    kets = [prec.take(k) for k in kets]
    fused = [prec.rnd(fuse(k)) for k in kets]
    single = chi_msg * chi * D ** 6 > recipe.blob_limit

    def fetch(source):
        if source[0] == "lat":
            return fused[source[1] % 3]
        if source[0] == "ket":
            return kets[source[1] % 3]
        _, side, k = source
        return prec.take(msg_sites[side][k])

    plans = [dataclasses.replace(p, single_layer=single) for p in (geo.top_plan, geo.bot_plan)]
    top = _row_sites(run_plan(plans[0], fetch, prec, recipe), geo.top_site_of, geo.chain)
    bot = _row_sites(run_plan(plans[1], fetch, prec, recipe), geo.bot_site_of, geo.chain)

    def node(v, c_in, c_out):
        """v's tensor with its legs [top, c_in, bottom, c_out] (a dim-1 leg
        where the row ends); the pair's kets with [i, ...] in front."""
        order = [geo.top_leg[v], c_in, geo.bot_leg[v], c_out]
        src = geo.graph.nodes[v].source
        if v in (n1, n2):
            t = kets[v % 3].permute((0,) + tuple(o + 1 for o in order))
            return t
        t = fused[v % 3] if src[0] == "lat" else fetch(src)
        legs = [o for o in order if o is not None]
        t = t.permute(legs)
        if c_in is None:
            t = t.unsqueeze(1)
        if c_out is None:
            t = t.unsqueeze(3)
        return t

    i1 = geo.chain.index(n1)
    assert geo.chain[i1 + 1] == n2
    one = torch.ones((1, 1, 1), dtype=prec.dtype, device=kets[0].device)
    # from the row's start forward to n1
    L = one
    for v in geo.chain[:i1]:
        L = prec.rnd(_walk_fused(L, top[v], bot[v], node(v, geo.bwd[v], geo.fwd[v])))
        L = L / torch.linalg.vector_norm(L)
    L = _walk_open(L, top[n1], bot[n1], node(n1, geo.bwd[n1], geo.fwd[n1]), D)
    # from the row's end backward to n2: sites flipped, legs swapped
    R = one
    for v in reversed(geo.chain[i1 + 2:]):
        R = prec.rnd(_walk_fused(R, _flip(top[v]), _flip(bot[v]), node(v, geo.fwd[v], geo.bwd[v])))
        R = R / torch.linalg.vector_norm(R)
    R = _walk_open(R, _flip(top[n2]), _flip(bot[n2]), node(n2, geo.fwd[n2], geo.bwd[n2]), D)
    rho = torch.einsum("tcbiI,tcbjJ->iIjJ", L, R)
    return rho / torch.einsum("iijj->", rho)


# ------------------- stage 2: gate, reduced env, ALS ------------------------
# Translated from the JAX package's ops/ite_kernels.py (rho_ij, reduced_env,
# als_optimize, gate_from_hamiltonian, apply_gate), itself the equations of
# the reference repo's src/libs/ITE.py: the Lubasch reduced environment with
# its gauge fix, the gate split by an SVD, and the ALS truncation of the
# shared bond with its spectral solve and QR/SVD re-gauging. The thresholds
# are the JAX package's for the configuration's dtype (ops/linalg.rtol_for).


def _sandwich(ket, bra, e0, e1, e2, ket_legs, bra_legs):
    """A ket [.., a, b, c] and its bra [.., x, y, z] closed by the three ring
    sites [prev, ket, bra, next] on their env legs; returns [ket_legs,
    bra_legs, prev, next]. One site at a time (ITE.py's mps-env mode)."""
    x = torch.einsum(f"{ket_legs}abc,paxq->{ket_legs}bcpxq", ket, e0)
    x = torch.einsum(f"{ket_legs}bcpxq,qbyr->{ket_legs}cpxyr", x, e1)
    x = torch.einsum(f"{ket_legs}cpxyr,rczs->{ket_legs}pxyzs", x, e2)
    return torch.einsum(f"{ket_legs}pxyzs,{bra_legs}xyz->{ket_legs}{bra_legs}ps", x, bra)


def rho_ij(t1, t2, env) -> torch.Tensor:
    """ρ[i, I, j, J] of the pair [d, e, x1, x2, x3] in a ring environment of
    six sites, trace one (ITE.py:555)."""
    a_i = _sandwich(t1, t1.conj(), env[0], env[1], env[2], "de", "DE")   # [d, e, D, E, p, s]
    a_j = _sandwich(t2, t2.conj(), env[3], env[4], env[5], "fe", "FE")   # [f, e, F, E, s, p]
    rho = torch.einsum("ieIEps,jeJEsp->iIjJ", a_i, a_j)
    return rho / torch.einsum("iijj->", rho)


def rtol_for(dtype: torch.dtype) -> float:
    """ops/linalg.rtol_for: the reference repo's 1e-10, widened to 1e-6 at
    32-bit precision."""
    return 1e-6 if torch.finfo(real_dtype(dtype)).bits <= 32 else 1e-10


def reduced_env(t1, t2, env, rtol: float, prec: Precision):
    """(X, a1, a2, t1_rest, t2_rest): t_i = a_i·t_i_rest by a QR of its
    environment legs, N_red = X·X† the pair's reduced environment, and both
    reduced legs gauge-fixed by the QR of X (ITE.py:853, 948, 1234)."""

    def split(t):
        d, e = t.shape[0], t.shape[1]
        q, r = qr_pos(t.reshape(d * e, -1).T)                 # mᵀ = q·r ⇒ m = rᵀ·qᵀ
        return prec.rnd(r.T.reshape(d, e, -1)), prec.rnd(q.T.reshape((-1,) + tuple(t.shape[2:])))

    a1, t1_rest = split(t1)
    a2, t2_rest = split(t2)
    n1 = _sandwich(t1_rest, t1_rest.conj(), env[0], env[1], env[2], "t", "T")
    n2 = _sandwich(t2_rest, t2_rest.conj(), env[3], env[4], env[5], "t", "T")
    n1 = prec.rnd(n1 / torch.linalg.vector_norm(n1))
    n2 = prec.rnd(n2 / torch.linalg.vector_norm(n2))
    nred = torch.einsum("rRps,qQsp->rqRQ", n1, n2)
    r1, r2 = nred.shape[0], nred.shape[1]
    eig_rtol = min(rtol, 1e-12) if rtol < 1e-7 else 1e-6
    x, _ = eigh_psd_sqrt(nred.reshape(r1 * r2, r1 * r2), eig_rtol)
    x = prec.rnd(x.reshape(r1, r2, -1))
    li = qr_pos(x.reshape(r1, -1).T)[1].T                     # [r1, r1']
    rj = qr_pos(x.permute(0, 2, 1).reshape(-1, r2))[1]        # [r2', r2]
    li_inv = torch.linalg.pinv(li, rtol=rtol)
    rj_inv = torch.linalg.pinv(rj, rtol=rtol)
    x = torch.einsum("ar,rsx,bs->abx", li_inv, x, rj_inv)
    t1_rest = prec.rnd(torch.tensordot(li_inv, t1_rest, dims=([1], [0])))
    t2_rest = prec.rnd(torch.tensordot(rj_inv.T, t2_rest, dims=([1], [0])))
    a1 = prec.rnd(torch.tensordot(a1, li, dims=([2], [0])))
    a2 = prec.rnd(torch.tensordot(a2, rj.T, dims=([2], [0])))
    return prec.rnd(x), a1, a2, t1_rest, t2_rest


def _normal_matrix(a_other, a_bra, x):
    """N[p, E, a; q, F, b] = δ_pq · (a_other·X)(a_bra·X)†, the local
    environment of one half with the other held (ITE.py:1394 Ni_env)."""
    ket = torch.einsum("dEr,arx->dEax", a_other, x)
    bra = torch.einsum("dEr,arx->dEax", a_bra, x)
    n = torch.einsum("dEax,dFbx->EaFb", ket, bra.conj())
    eye = torch.eye(a_other.shape[0], dtype=a_other.dtype, device=a_other.device)
    return torch.einsum("pq,EaFb->pEaqFb", eye, n)


def _als_half(exact_a, new_other, exact_other, x, shape, rtol, prec):
    """The half that best fits the exact pair with the other half held:
    N·a = b solved on N's supported eigenspace (ops/linalg.robust_solve)."""
    n = _normal_matrix(new_other, new_other, x)
    m = n.shape[0] * n.shape[1] * n.shape[2]
    b = torch.einsum("pEaqFb,pEa->qFb", _normal_matrix(exact_other, new_other, x), exact_a)
    return prec.rnd(psd_solve(n.reshape(m, m).T, b.reshape(-1), max(rtol, 1e-14)).reshape(shape))


def gate_and_truncate(t1, t2, env, h, dt: float, als_iters: int, rtol: float,
                      prec: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1', t2') of one update from the pair [d, e, x1, x2, x3] and the
    ring environment the program used, unit norm each (apply_gate)."""
    t1, t2, h = prec.take(t1), prec.take(t2), prec.take(h)
    env = [prec.take(e) for e in env]
    d_max = t1.shape[1]
    x, a1, a2, t1_rest, t2_rest = reduced_env(t1, t2, env, rtol, prec)

    # the gate g = exp(−dt·h) on the reduced pair, split by an SVD
    d, r1, r2 = a1.shape[0], a1.shape[2], a2.shape[2]
    g = torch.linalg.matrix_exp(-dt * h.permute(0, 2, 1, 3).reshape(d * d, d * d))
    g = g.reshape(d, d, d, d).permute(0, 2, 1, 3)                       # [i, I, j, J]
    theta = torch.einsum("iIjJ,Ier,Jes->irjs", g, a1, a2)
    u, s, vh = torch.linalg.svd(theta.reshape(d * r1, d * r2), full_matrices=False)
    sq = torch.sqrt(s).to(u.dtype)
    ea1 = prec.rnd((u * sq[None, :]).reshape(d, r1, -1).permute(0, 2, 1))   # [d, e, r1]
    ea2 = prec.rnd((sq[:, None] * vh).reshape(-1, d, r2).permute(1, 0, 2))  # [d, e, r2]

    # ALS truncation of the shared bond to d_max (ITE.py:1518), each round
    # re-gauged by the QR of both halves and the SVD of their core (1688)
    new_a1, new_a2 = ea1[:, :d_max, :], ea2[:, :d_max, :]
    xs = x.permute(1, 0, 2)
    for _ in range(als_iters):
        new_a1 = _als_half(ea1, new_a2, ea2, x, new_a1.shape, rtol, prec)
        new_a2 = _als_half(ea2, new_a1, ea1, xs, new_a2.shape, rtol, prec)
        q1, r1m = qr_pos(new_a1.permute(0, 2, 1).reshape(d * r1, d_max))
        q2, r2m = qr_pos(new_a2.permute(1, 0, 2).reshape(d_max, d * r2).T)
        uu, ss, vv = torch.linalg.svd(r1m @ r2m.T, full_matrices=False)
        sq = torch.sqrt(ss).to(q1.dtype)
        new_a1 = prec.rnd(((q1 @ uu) * sq[None, :]).reshape(d, r1, d_max).permute(0, 2, 1))
        new_a2 = prec.rnd(((sq[:, None] * vv) @ q2.T).reshape(d_max, d, r2).permute(1, 0, 2))
    t1n = torch.tensordot(new_a1, t1_rest, dims=([2], [0]))
    t2n = torch.tensordot(new_a2, t2_rest, dims=([2], [0]))
    return (prec.rnd(t1n / torch.linalg.vector_norm(t1n)),
            prec.rnd(t2n / torch.linalg.vector_norm(t2n)))


def pair_state(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """The pair's state over its outer legs: t1 and t2 [d, e, x1, x2, x3]
    contracted over the shared leg e; no gauge of that leg is left in it."""
    return torch.einsum("iexyz,jeuvw->ixyzjuvw", t1.to(torch.complex128), t2.to(torch.complex128))
