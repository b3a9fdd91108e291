"""Small closed-form linear algebra for minimal solvers (port of
``ransac_tpu.ops.linalg``).

Branch-free (``torch.where``) batched real cubic/quartic roots, the
unrolled pivoted Gaussian elimination whose pivot flag decides which
minimal-solver hypotheses are valid, the pivot-free Gauss-Jordan solve of
damped SPD systems, inverse-iteration nullspaces, and the
closed-form 3x3 inverse / symmetric eigendecomposition / SVD that
``rotation.project_to_so3`` needs.  Every function takes leading batch
dimensions ``[...]`` and is safe under ``torch.func.vmap``/``jacfwd``
(no data-dependent Python branches, no ``.item()``).
"""

from __future__ import annotations

import math

import torch


def _guard(x, eps):
    """``where(|x| < eps, eps, x)``: the JAX package's division guard."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def solve_cubic_real(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d = 0 (a assumed nonzero).

    Returns (roots [...,3], valid [...,3]); in the one-real-root case the
    extra slots repeat the real root with valid=False.
    """
    a = _guard(a, 1e-30)
    b_, c_, d_ = b / a, c / a, d / a
    # Depressed: t^3 + p t + q with x = t - b/3.
    shift = b_ / 3.0
    p = c_ - b_ * b_ / 3.0
    q = 2.0 * b_**3 / 27.0 - b_ * c_ / 3.0 + d_
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # Trig branch (disc <= 0): three real roots.
    p_neg = torch.clamp(p, max=-1e-30)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.acos(arg) / 3.0
    two_pi_3 = 2.0943951023931953
    t_trig = torch.stack(
        [m * torch.cos(theta),
         m * torch.cos(theta - two_pi_3),
         m * torch.cos(theta - 2.0 * two_pi_3)], dim=-1)

    # Cardano branch (disc > 0): one real root.
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    t_card3 = torch.stack([t_card, t_card, t_card], dim=-1)

    use_trig = (disc <= 0.0)[..., None]
    t = torch.where(use_trig, t_trig, t_card3)
    roots = t - shift[..., None]
    valid = torch.cat(
        [torch.ones_like(use_trig), use_trig, use_trig], dim=-1)
    return roots, valid


def solve_quartic_real(a, b, c, d, e):
    """Real roots of a x^4 + b x^3 + c x^2 + d x + e = 0 via Ferrari.

    Returns (roots [...,4], valid [...,4]); invalid slots hold 0.
    """
    a = _guard(a, 1e-30)
    b_, c_, d_, e_ = b / a, c / a, d / a, e / a
    # Depressed quartic y^4 + p y^2 + q y + r, x = y - b/4.
    shift = b_ / 4.0
    b2 = b_ * b_
    p = c_ - 3.0 * b2 / 8.0
    q = d_ - b_ * c_ / 2.0 + b2 * b_ / 8.0
    r = e_ - b_ * d_ / 4.0 + b2 * c_ / 16.0 - 3.0 * b2 * b2 / 256.0

    # Resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0; its largest
    # real root is strictly positive for q != 0.
    m_roots, m_valid = solve_cubic_real(
        torch.ones_like(p), p, p * p / 4.0 - r, -q * q / 8.0)
    m_cand = torch.where(m_valid, m_roots, torch.full_like(m_roots, -math.inf))
    m = torch.clamp(m_cand.amax(dim=-1), min=1e-12)

    s = torch.sqrt(2.0 * m)
    q_term = q / (2.0 * s)
    base = p / 2.0 + m

    def quad(sign):
        cc = base + sign * q_term
        disc = s * s / 4.0 - cc
        ok = disc >= 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return (sign * s / 2.0 + sq, ok), (sign * s / 2.0 - sq, ok)

    (y1, ok1), (y2, ok2) = quad(1.0)
    (y3, ok3), (y4, ok4) = quad(-1.0)
    ys = torch.stack([y1, y2, y3, y4], dim=-1)
    ok = torch.stack([ok1, ok2, ok3, ok4], dim=-1)
    zero = torch.zeros_like(ys)
    roots = torch.where(ok, ys - shift[..., None], zero)

    bb, cc_, dd, ee = (v[..., None] for v in (b_, c_, d_, e_))
    # Two Newton polish steps on the original quartic (improves f32 roots).
    for _ in range(2):
        f = roots**4 + bb * roots**3 + cc_ * roots**2 + dd * roots + ee
        df = 4.0 * roots**3 + 3.0 * bb * roots**2 + 2.0 * cc_ * roots + dd
        roots = roots - f / _guard(df, 1e-20)
    roots = torch.where(ok, roots, zero)
    return roots, ok


def solve_unrolled(A: torch.Tensor, b: torch.Tensor):
    """Batched small dense solve by unrolled Gaussian elimination with
    partial pivoting.  A [..., n, n], b [..., n] with small n.

    Returns (x [..., n], ok [...]) where ``ok`` flags pivots above 1e-12;
    the homography engine uses it to decide which minimal samples are
    valid, so it is kept exactly (not replaced by ``torch.linalg.solve``).
    The row swap is the JAX version's one-hot blend, with the pivot row
    found by ``argmax`` (first maximum, as ``jnp.argmax``) and ``gather``.
    """
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)  # [..., n, n+1]
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    for k in range(n):
        col = M[..., k:, k].abs()                         # [..., n-k]
        piv_rel = col.argmax(dim=-1)                      # [...]
        piv_val = col.gather(-1, piv_rel[..., None])[..., 0]
        ok = ok & (piv_val > 1e-12)
        rows = M[..., k:, :]                              # [..., n-k, n+1]
        pivot_row = rows.gather(
            -2, piv_rel[..., None, None].expand(*piv_rel.shape, 1, n + 1)
        )[..., 0, :]
        sel = _one_hot(piv_rel, n - k, M.dtype)
        row_k = rows[..., 0, :]
        rows = rows - sel[..., None] * (pivot_row - row_k)[..., None, :]
        # Eliminate below the (swapped-in) pivot row.
        inv_pk = 1.0 / _guard(pivot_row[..., k], 1e-12)
        factors = rows[..., 1:, k] * inv_pk[..., None]
        below = rows[..., 1:, :] - factors[..., None] * pivot_row[..., None, :]
        M = torch.cat([M[..., :k, :], pivot_row[..., None, :], below], dim=-2)
    # Back substitution.
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        rhs = M[..., k, n]
        if k + 1 < n:
            rhs = rhs - (M[..., k, k + 1:n]
                         * torch.stack(xs[k + 1:], dim=-1)).sum(-1)
        xs[k] = rhs * (1.0 / _guard(M[..., k, k], 1e-12))
    return torch.stack(xs, dim=-1), ok


def nullspace_last_fast(A: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Smallest right-singular vector of A [...,m,n] by inverse iteration
    on the shifted normal matrix through :func:`solve_unrolled`; two
    deterministic starts, the lower Rayleigh quotient wins."""
    n = A.shape[-1]
    M = A.transpose(-1, -2) @ A
    tr = M.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ms = M + (1e-6 * tr / n + 1e-30) * eye
    batch = M.shape[:-2]

    def run(x0):
        x = x0.expand(*batch, n)
        for _ in range(iters):
            x, _ = solve_unrolled(Ms, x)
            nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            x = x / torch.clamp(nrm, min=1e-30)
        return x

    x1 = run(eye[-1])
    x2 = run(torch.full((n,), 1.0 / math.sqrt(float(n)), dtype=A.dtype,
                        device=A.device))

    def rq(x):
        return (x[..., :, None] * M * x[..., None, :]).sum((-2, -1))

    pick = (rq(x1) <= rq(x2))[..., None]
    return torch.where(pick, x1, x2)


def solve_spd_gj(A: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Solve a damped SPD system by pivot-free Gauss-Jordan: A [..., N, N],
    b [..., N] -> x [..., N].

    The JAX function's elimination order on the [N, N+1] augmented matrix,
    one trip a row: the pivot row is divided by its pivot (an ``eps`` guard
    for |pivot| < eps), its own column entry is zeroed, every row takes the
    rank-1 update, and the pivot row is written back.  No pivoting: the
    Levenberg-Marquardt normal matrices it serves are SPD.  Kept in this
    order rather than ``torch.linalg.solve`` / ``cholesky_solve`` so that it
    rounds as the JAX function does (and reads nothing back to the host)."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)
    rows = torch.arange(n, device=A.device)[:, None]
    for k in range(n):
        piv = M[..., k, k:k + 1]
        row = M[..., k, :] / torch.where(piv.abs() < eps, eps, piv)
        col = torch.where(rows == k, 0.0, M[..., :, k:k + 1])
        M = M - col * row[..., None, :]
        M[..., k, :] = row
    return M[..., :, n]


def inv3x3(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det); ``eps`` is added
    to the diagonal first."""
    if eps:
        A = A + eps * torch.eye(3, dtype=A.dtype, device=A.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / _guard(det, 1e-30)
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _cross(u, v):
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def _unit(v):
    return v / torch.clamp(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _one_hot(idx, n, dtype):
    # Comparison form: vmap-safe, unlike ``F.one_hot``.
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def eigh3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of a symmetric 3x3 batch.

    Returns (eigvals ascending [...,3], V [...,3,3] orthonormal columns):
    trigonometric (Smith) eigenvalues; the most isolated eigenvalue's
    vector from the largest row cross product of (A - lam I); the other
    two from an exact 2x2 Jacobi rotation in its complement.
    """
    scale = torch.clamp(A.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    A = A / scale
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detb = (b00 * (a11 - q) * (a22 - q) + 2.0 * a01 * a12 * a02
            - b00 * a12 * a12 - b11 * a02 * a02 - b22 * a01 * a01)
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    two_pi_3 = 2.0943951023931953
    l2 = q + 2.0 * p * torch.cos(phi)              # largest
    l0 = q + 2.0 * p * torch.cos(phi + two_pi_3)   # smallest
    l1 = 3.0 * q - l0 - l2

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    iso_is_low = (l1 - l0) > (l2 - l1)
    lam_iso = torch.where(iso_is_low, l0, l2)
    B = A - lam_iso[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    pick = _one_hot(torch.stack([n01, n02, n12], -1).argmax(-1), 3, A.dtype)
    v_iso = _unit(pick[..., 0:1] * c01 + pick[..., 1:2] * c02
                  + pick[..., 2:3] * c12)
    # Guard: a (near-)spherical A has vanishing crosses; fall back to e0.
    spherical = torch.maximum(torch.maximum(n01, n02), n12) < 1e-24
    v_iso = torch.where(spherical[..., None], eye[0].expand_as(v_iso), v_iso)

    axis = _one_hot(v_iso.abs().argmin(-1), 3, A.dtype)
    w1 = _unit(_cross(v_iso, axis))
    w2 = _cross(v_iso, w1)
    Aw1 = (A @ w1[..., None])[..., 0]
    Aw2 = (A @ w2[..., None])[..., 0]
    ra = (w1 * Aw1).sum(-1)
    rb = (w1 * Aw2).sum(-1)
    rc = (w2 * Aw2).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * rb, ra - rc)
    ct, st = torch.cos(theta), torch.sin(theta)
    vp = ct[..., None] * w1 + st[..., None] * w2
    vq = -st[..., None] * w1 + ct[..., None] * w2
    lp = ct * ct * ra + 2.0 * ct * st * rb + st * st * rc
    lq = st * st * ra - 2.0 * ct * st * rb + ct * ct * rc
    swap = lp > lq
    m_lo = torch.where(swap, lq, lp)
    m_hi = torch.where(swap, lp, lq)
    v_lo = torch.where(swap[..., None], vq, vp)
    v_hi = torch.where(swap[..., None], vp, vq)

    low = iso_is_low[..., None]
    e0 = torch.where(iso_is_low, lam_iso, m_lo)
    e1 = torch.where(iso_is_low, m_lo, m_hi)
    e2 = torch.where(iso_is_low, m_hi, lam_iso)
    V0 = torch.where(low, v_iso, v_lo)
    V1 = torch.where(low, v_lo, v_hi)
    V2 = torch.where(low, v_hi, v_iso)
    vals = torch.stack([e0, e1, e2], -1) * scale[..., 0]
    return vals, torch.stack([V0, V1, V2], -1)


def svd3x3(F: torch.Tensor):
    """Closed-form batched 3x3 SVD F = U diag(S) Vt, S descending, via
    :func:`eigh3x3` of F^T F (det(U) = +1 unless sigma_3 is
    non-negligible and F v3 points the other way)."""
    lam, V = eigh3x3(F.transpose(-1, -2) @ F)
    lam_d = lam.flip(-1)
    V = V.flip(-1)
    S = torch.sqrt(torch.clamp(lam_d, min=0.0))
    u0 = (F @ V[..., 0, None])[..., 0] / torch.clamp(S[..., 0], min=1e-30)[..., None]
    u1 = (F @ V[..., 1, None])[..., 0] / torch.clamp(S[..., 1], min=1e-30)[..., None]
    # f32 safety: re-orthonormalize u1 against u0.
    u0 = _unit(u0)
    u1 = _unit(u1 - (u0 * u1).sum(-1, keepdim=True) * u0)
    u2 = _cross(u0, u1)
    fv2 = (F @ V[..., 2, None])[..., 0]
    flip = (((u2 * fv2).sum(-1) < 0.0)
            & (S[..., 2] > 1e-6 * torch.clamp(S[..., 0], min=1e-30)))
    u2 = torch.where(flip[..., None], -u2, u2)
    U = torch.stack([u0, u1, u2], -1)
    return U, S, V.transpose(-1, -2)
