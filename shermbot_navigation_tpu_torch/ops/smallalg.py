"""Closed-form small-matrix algebra (port of
``shermbot_navigation_tpu.ops.smallalg``).

The JAX package wrote these because ``jnp.linalg`` on tiny systems is slow
inside a TPU scan. The port keeps them because they are the contract: the
circle fit's eigen-chain goes through :func:`eigh4_jacobi_c`, and its
operation order decides which eigenvector a near-degenerate fit picks. All
functions broadcast over leading batch dims and are branchless.
"""

from __future__ import annotations

import torch


def _floor_det(det, eps: float):
    return torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)


def inv2(M, eps: float = 1e-30):
    """Closed-form 2x2 inverse (batched)."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = _floor_det(a * d - b * c, eps)
    out = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return out / det[..., None, None]


def solve3(M, v, eps: float = 1e-30):
    """Closed-form 3x3 solve via the adjugate (batched): ``M x = v``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = _floor_det(a * A + b * D + c * G, eps)
    x0 = A * v[..., 0] + B * v[..., 1] + C * v[..., 2]
    x1 = D * v[..., 0] + E * v[..., 1] + F * v[..., 2]
    x2 = G * v[..., 0] + H * v[..., 1] + I * v[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def _adjugate4(m, eps: float):
    """Cofactor expansion shared by :func:`solve4` and :func:`solve4_c`:
    ``m`` is a 4x4 list-of-lists of (batched) tensors; returns the adjugate
    as a list-of-lists and the floored determinant."""
    s0 = m[2][0] * m[3][1] - m[2][1] * m[3][0]
    s1 = m[2][0] * m[3][2] - m[2][2] * m[3][0]
    s2 = m[2][0] * m[3][3] - m[2][3] * m[3][0]
    s3 = m[2][1] * m[3][2] - m[2][2] * m[3][1]
    s4 = m[2][1] * m[3][3] - m[2][3] * m[3][1]
    s5 = m[2][2] * m[3][3] - m[2][3] * m[3][2]
    c0 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    c1 = m[0][0] * m[1][2] - m[0][2] * m[1][0]
    c2 = m[0][0] * m[1][3] - m[0][3] * m[1][0]
    c3 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c4 = m[0][1] * m[1][3] - m[0][3] * m[1][1]
    c5 = m[0][2] * m[1][3] - m[0][3] * m[1][2]

    det = c0 * s5 - c1 * s4 + c2 * s3 + c3 * s2 - c4 * s1 + c5 * s0
    det = _floor_det(det, eps)

    adj = [
        [m[1][1] * s5 - m[1][2] * s4 + m[1][3] * s3,
         -m[0][1] * s5 + m[0][2] * s4 - m[0][3] * s3,
         m[3][1] * c5 - m[3][2] * c4 + m[3][3] * c3,
         -m[2][1] * c5 + m[2][2] * c4 - m[2][3] * c3],
        [-m[1][0] * s5 + m[1][2] * s2 - m[1][3] * s1,
         m[0][0] * s5 - m[0][2] * s2 + m[0][3] * s1,
         -m[3][0] * c5 + m[3][2] * c2 - m[3][3] * c1,
         m[2][0] * c5 - m[2][2] * c2 + m[2][3] * c1],
        [m[1][0] * s4 - m[1][1] * s2 + m[1][3] * s0,
         -m[0][0] * s4 + m[0][1] * s2 - m[0][3] * s0,
         m[3][0] * c4 - m[3][1] * c2 + m[3][3] * c0,
         -m[2][0] * c4 + m[2][1] * c2 - m[2][3] * c0],
        [-m[1][0] * s3 + m[1][1] * s1 - m[1][2] * s0,
         m[0][0] * s3 - m[0][1] * s1 + m[0][2] * s0,
         -m[3][0] * c3 + m[3][1] * c1 - m[3][2] * c0,
         m[2][0] * c3 - m[2][1] * c1 + m[2][2] * c0],
    ]
    return adj, det


def solve4(M, v, eps: float = 1e-30):
    """4x4 solve by cofactor expansion of the inverse (batched): the
    adjugate over the floored determinant, then the matrix-vector product
    (the JAX version's order: ``inv = adj / det`` first)."""
    m = [[M[..., i, j] for j in range(4)] for i in range(4)]
    adj, det = _adjugate4(m, eps)
    inv = [[adj[i][j] / det for j in range(4)] for i in range(4)]
    return torch.stack(
        [inv[i][0] * v[..., 0] + inv[i][1] * v[..., 1]
         + inv[i][2] * v[..., 2] + inv[i][3] * v[..., 3]
         for i in range(4)], dim=-1)


def solve4_c(Mc, vc, eps: float = 1e-30):
    """Component form of :func:`solve4`: ``Mc`` is a 4x4 list-of-lists,
    ``vc`` a length-4 list; returns a length-4 list (the product first,
    then the division by the determinant, as in the JAX version)."""
    adj, det = _adjugate4(Mc, eps)
    return [(adj[i][0] * vc[0] + adj[i][1] * vc[1]
             + adj[i][2] * vc[2] + adj[i][3] * vc[3]) / det
            for i in range(4)]


_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_SORT_NET = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def eigh4_jacobi_c(A_comps, sweeps: int = 8):
    """Fully-componentized symmetric 4x4 eigendecomposition (cyclic Jacobi,
    fixed sweep count, branchless).

    ``A_comps``: length-16 list of (batched, arbitrary-shape) tensors, the
    matrix entries row-major. Returns ``(lam, V)`` with ``lam`` a length-4
    list (ascending) and ``V`` a 4x4 list-of-lists (columns are
    eigenvectors).

    The operation order is the JAX version's exactly (symmetrize; per sweep
    the pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3); ``theta = 0.5
    atan2(2 A_pq, A_qq - A_pp)``; rows then columns; the 5-comparator sort):
    it decides which eigenvector a near-degenerate fit picks. The JAX
    ``lax.scan`` over sweeps is a Python loop here.
    """
    A = [[0.5 * (A_comps[i * 4 + j] + A_comps[j * 4 + i]) for j in range(4)]
         for i in range(4)]
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    V = [[one if i == j else zero for j in range(4)] for i in range(4)]

    for _ in range(sweeps):
        for (p, q) in _PAIRS:
            theta = 0.5 * torch.atan2(2.0 * A[p][q], A[q][q] - A[p][p])
            c = torch.cos(theta)
            s = torch.sin(theta)
            # B = G^T A (rows p, q), then A' = B G (cols p, q); V' = V G.
            # G = I except G[pp]=G[qq]=c, G[pq]=s, G[qp]=-s.
            Bp = [c * A[p][k] - s * A[q][k] for k in range(4)]
            Bq = [s * A[p][k] + c * A[q][k] for k in range(4)]
            B = [Bp if i == p else Bq if i == q else A[i] for i in range(4)]
            A = [[(c * B[i][p] - s * B[i][q]) if j == p
                  else (s * B[i][p] + c * B[i][q]) if j == q
                  else B[i][j]
                  for j in range(4)] for i in range(4)]
            V = [[(c * V[i][p] - s * V[i][q]) if j == p
                  else (s * V[i][p] + c * V[i][q]) if j == q
                  else V[i][j]
                  for j in range(4)] for i in range(4)]

    lam = [A[i][i] for i in range(4)]
    # ascending sort: 5-comparator network, swapping (eigenvalue, column)
    for (k, l) in _SORT_NET:
        take = lam[k] > lam[l]
        lam[k], lam[l] = (torch.where(take, lam[l], lam[k]),
                          torch.where(take, lam[k], lam[l]))
        for i in range(4):
            V[i][k], V[i][l] = (torch.where(take, V[i][l], V[i][k]),
                                torch.where(take, V[i][k], V[i][l]))
    return lam, V


def eigh4_jacobi(M, sweeps: int = 8):
    """Symmetric 4x4 eigendecomposition via cyclic Jacobi rotations,
    batched and branchless. Returns (eigenvalues ascending, eigenvectors as
    columns), ``torch.linalg.eigh``'s convention; a tensor wrapper around
    :func:`eigh4_jacobi_c`."""
    comps = [M[..., i, j] for i in range(4) for j in range(4)]
    lam, V = eigh4_jacobi_c(comps, sweeps=sweeps)
    return (torch.stack(lam, dim=-1),
            torch.stack([torch.stack(V[i], dim=-1) for i in range(4)],
                        dim=-2))
