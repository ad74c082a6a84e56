"""Block-tridiagonal + low-rank (Woodbury) reduced-camera solve.

At reference scale (~10^3 poses, UT campus global BA,
``sequences/evaluation_2023_07_v1.json``) the dense reduced system is
(6P)^2 ~ 150 MB and its O(P^3) Cholesky dominates the LM iteration — the
cost Ceres avoids with SPARSE_SCHUR's sparse factorization
(``object_pose_graph_optimizer.h:652-666``). The answer here exploits
the SAME structure the banded gram already exposes (schur._band_layout):

  - feature tracks span <= 2 consecutive 64-pose tiles, so the point Schur
    subtraction couples only same/adjacent tiles -> block-TRIDIAGONAL at
    384 (= 6*64) granularity;
  - odometry/PGO relpose factors are consecutive-frame -> tridiagonal;
  - object (bbox) couplings span arbitrary frames but have rank <= 7K
    (K objects) -> a low-rank correction, S = B - Z^T Z.

The solve is then a block-tridiagonal Cholesky (lax.scan over ~P/64 tiles,
O(P b^2) instead of O(P^3)) plus a Woodbury correction:

  S^-1 r = B^-1 r + Y C^-1 Z (B^-1 r),   Y = B^-1 Z^T,  C = I - Z Y
  (C is PD whenever S and B are: it is the Schur complement of B in
   [[B, Z^T], [Z, I]]).

All tiles are (384, 384) in the banded path's native c-major-within-tile
layout ((component, pose_local) flattening), so no S-sized buffer is ever
materialized and no layout permute is needed.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

_P_HI = jax.lax.Precision.HIGHEST

# Cyclic-reduction gate: "auto" switches to CR at >= OBVI_BAND_CR_MIN_NB
# tiles; "on"/"off" force.
_BAND_CR = os.environ.get("OBVI_BAND_CR", "auto")
_BAND_CR_MIN_NB = int(os.environ.get("OBVI_BAND_CR_MIN_NB", "8"))


def _use_cyclic_reduction(nb: int) -> bool:
    if _BAND_CR == "off":
        return False
    if _BAND_CR == "on":
        return True
    return nb >= _BAND_CR_MIN_NB


def _mm(a, b, ta=False, tb=False):
    return jnp.matmul(
        a.T if ta else a,
        b.T if tb else b,
        precision=_P_HI,
    )


def block_tridiag_cholesky(d_tiles, e_tiles):
    """Cholesky of a symmetric PD block-tridiagonal matrix.

    ``d_tiles``: (nb, m, m) diagonal blocks (full symmetric tiles);
    ``e_tiles``: (nb-1, m, m) sub-diagonal blocks, e_tiles[i] = B[i+1, i].
    Returns (l_d, l_e): l_d[i] lower-triangular with
    L[i, i] = l_d[i], L[i+1, i] = l_e[i].

      A_0 = D_0;  A_{i+1} = D_{i+1} - L_{i+1,i} L_{i+1,i}^T
      L_ii = chol(A_i);  L_{i+1,i} = E_i L_ii^{-T}
    """
    nb, m, _ = d_tiles.shape

    def step(carry, inp):
        contrib = carry  # L_{i,i-1} L_{i,i-1}^T (zero for i=0)
        d_i, e_i = inp
        a_i = d_i - contrib
        l_ii = jax.lax.linalg.cholesky(a_i, symmetrize_input=False)
        # L_{i+1,i} = E_i L_ii^{-T}  <=>  solve L_ii X^T = E_i^T.
        l_next = solve_triangular(
            l_ii, e_i.T, lower=True, trans=0
        ).T
        return _mm(l_next, l_next, tb=True), (l_ii, l_next)

    # Pad e with a zero tile so the scan consumes aligned pairs; the last
    # emitted l_e row is garbage-free (zero input -> zero output) and unused.
    e_pad = jnp.concatenate(
        [e_tiles, jnp.zeros((1, m, m), d_tiles.dtype)], axis=0
    )
    _, (l_d, l_e) = jax.lax.scan(
        step, jnp.zeros((m, m), d_tiles.dtype), (d_tiles, e_pad)
    )
    return l_d, l_e[:-1]


def block_tridiag_solve(l_d, l_e, rhs):
    """Solve B x = rhs given the block-tridiagonal Cholesky factors.

    ``rhs``: (nb, m, k). Forward then backward block substitution."""
    nb, m, _ = l_d.shape
    zero_off = jnp.zeros((1, m, m), l_d.dtype)
    l_e_fwd = jnp.concatenate([zero_off, l_e], axis=0)  # L_{i,i-1}

    def fwd(y_prev, inp):
        l_ii, l_lo, r_i = inp
        y_i = solve_triangular(
            l_ii, r_i - _mm(l_lo, y_prev), lower=True
        )
        return y_i, y_i

    k = rhs.shape[-1]
    _, y = jax.lax.scan(
        fwd, jnp.zeros((m, k), rhs.dtype), (l_d, l_e_fwd, rhs)
    )

    l_e_bwd = jnp.concatenate([l_e, zero_off], axis=0)  # L_{i+1,i}

    def bwd(x_next, inp):
        l_ii, l_lo, y_i = inp
        x_i = solve_triangular(
            l_ii, y_i - _mm(l_lo, x_next, ta=True), lower=True, trans=1
        )
        return x_i, x_i

    _, x = jax.lax.scan(
        bwd,
        jnp.zeros((m, k), rhs.dtype),
        (l_d, l_e_bwd, y),
        reverse=True,
    )
    return x


def _chol_solve(chol, b):
    """Batched SPD solve from a (batched) Cholesky factor."""
    y = solve_triangular(chol, b, lower=True)
    return solve_triangular(chol, y, lower=True, trans=1)


def cr_factor(d_tiles, e_tiles):
    """Block CYCLIC-REDUCTION factorization of an SPD block-tridiagonal
    matrix: each level eliminates the odd-indexed blocks IN PARALLEL
    (batched Cholesky + batched matmuls), halving the system — log2(nb)
    sequential stages instead of nb. The sequential block-tridiag scan
    (block_tridiag_cholesky) is latency-bound (one small dependent step
    per tile); cyclic reduction trades ~2x the FLOPs for ~4 batched stages.

    Returns an opaque ``levels`` structure for cr_solve. Blocks are padded
    with identity diagonals / zero couplings to an even count per level
    (solving an uncoupled I x = b_pad block, harmless).
    """
    levels = []
    d, e = d_tiles, e_tiles
    while d.shape[0] > 1:
        nb, m, _ = d.shape
        if nb % 2 == 1:
            d = jnp.concatenate(
                [d, jnp.eye(m, dtype=d.dtype)[None]], axis=0
            )
            e = jnp.concatenate(
                [e, jnp.zeros((1, m, m), d.dtype)], axis=0
            )
            nb += 1
        # e has nb-1 live couplings; pad one zero so eR[k] = e[2k+1] exists
        # for the last odd block.
        e_pad = jnp.concatenate([e, jnp.zeros((1, m, m), d.dtype)], axis=0)
        d_odd = d[1::2]  # (h, m, m) — blocks 2k+1
        e_l = e_pad[0::2]  # E_{2k}  : couples even 2k -> odd 2k+1
        e_r = e_pad[1::2]  # E_{2k+1}: couples odd 2k+1 -> even 2k+2
        chol_odd = jax.lax.linalg.cholesky(d_odd, symmetrize_input=False)
        p_l = _chol_solve(chol_odd, e_l)  # D_odd^-1 E_{2k}
        p_r = _chol_solve(
            chol_odd, jnp.swapaxes(e_r, -1, -2)
        )  # D_odd^-1 E_{2k+1}^T
        d_even = d[0::2]
        term_r = jnp.matmul(
            jnp.swapaxes(e_l, -1, -2), p_l, precision=_P_HI
        )  # E_{2k}^T D^-1 E_{2k} at even 2k
        term_l = jnp.matmul(e_r, p_r, precision=_P_HI)  # at even 2k+2
        d_new = d_even - term_r
        d_new = d_new.at[1:].add(-term_l[:-1])
        e_new = -jnp.matmul(e_r, p_l, precision=_P_HI)[:-1]  # A'[k+1, k]
        levels.append((chol_odd, e_l, e_r))
        d, e = d_new, e_new
    root_chol = jax.lax.linalg.cholesky(d[0], symmetrize_input=False)
    return levels, root_chol


def cr_solve(factors, rhs):
    """Solve B x = rhs with cr_factor's output. ``rhs``: (nb, m, k)."""
    levels, root_chol = factors
    stack = []
    b = rhs
    for chol_odd, e_l, e_r in levels:
        nb_orig, m, k = b.shape
        nb = nb_orig
        if nb % 2 == 1:
            b = jnp.concatenate([b, jnp.zeros((1, m, k), b.dtype)], axis=0)
            nb += 1
        b_odd = b[1::2]
        b_even = b[0::2]
        u = _chol_solve(chol_odd, b_odd)  # D_odd^-1 b_odd
        b_new = b_even - jnp.matmul(
            jnp.swapaxes(e_l, -1, -2), u, precision=_P_HI
        )
        b_new = b_new.at[1:].add(
            -jnp.matmul(e_r[:-1], u[:-1], precision=_P_HI)
        )
        stack.append((chol_odd, e_l, e_r, b_odd, nb, nb_orig))
        b = b_new
    x = solve_triangular(root_chol, b[0], lower=True)
    x = solve_triangular(root_chol, x, lower=True, trans=1)[None]
    for chol_odd, e_l, e_r, b_odd, nb, nb_orig in reversed(stack):
        m, k = b_odd.shape[-2], b_odd.shape[-1]
        x_even = x  # (nb//2, m, k)
        r = b_odd - jnp.matmul(e_l, x_even, precision=_P_HI)
        # E_{2k+1}^T x_{2k+2}: shift even solutions left; last odd block's
        # right neighbor is the padding (zero).
        x_next = jnp.concatenate(
            [x_even[1:], jnp.zeros((1, m, k), x.dtype)], axis=0
        )
        r = r - jnp.matmul(
            jnp.swapaxes(e_r, -1, -2), x_next, precision=_P_HI
        )
        x_odd = _chol_solve(chol_odd, r)
        x_full = jnp.zeros((nb, m, k), x.dtype)
        x_full = x_full.at[0::2].set(x_even).at[1::2].set(x_odd)
        x = x_full[:nb_orig]  # drop this level's even-pad block, if any
    return x


def block_tridiag_matvec(d_tiles, e_tiles, x):
    """B @ x for block-tridiagonal B, x: (nb, m, k)."""
    nb, m, _ = d_tiles.shape
    out = jnp.matmul(d_tiles, x, precision=_P_HI)
    lo = jnp.matmul(e_tiles, x[:-1], precision=_P_HI)  # block (i+1,i) x_i
    hi = jnp.matmul(
        jnp.swapaxes(e_tiles, -1, -2), x[1:], precision=_P_HI
    )  # block (i,i+1) x_{i+1}
    out = out.at[1:].add(lo).at[:-1].add(hi)
    return out


def _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine,
                          matvec=None):
    """Woodbury correction + iterative refinement given a B-solver.

    Shared tail of woodbury_band_solve and dd_woodbury_band_solve:
    ``b_solve`` maps (nb*m, k) -> (nb*m, k) solving B v = rhs for the
    block-tridiagonal part. ``matvec`` optionally overrides the B x
    product used by refinement (the DD path supplies a domain-local one)."""
    nb, m, _ = d_tiles.shape
    rz = z.shape[0]
    dtype = d_tiles.dtype

    # ONE band traversal for rhs + Z together: the scans are sequential over
    # tiles (latency-bound), so extra right-hand sides ride along for
    # almost free while a separate traversal costs a full chain of
    # dispatch-dependent steps.
    y_all = b_solve(jnp.concatenate([rhs[:, None], z.T], axis=1))
    x0_first = y_all[:, 0]
    y = y_all[:, 1:]  # (nb*m, rz) = B^-1 Z^T
    c = jnp.eye(rz, dtype=dtype) - _mm(z, y)
    l_c = jax.lax.linalg.cholesky(
        0.5 * (c + c.T), symmetrize_input=False
    )

    def s_correct(x0):
        w = jnp.matmul(z, x0, precision=_P_HI)  # (rz,)
        t = solve_triangular(l_c, w, lower=True)
        t = solve_triangular(l_c, t, lower=True, trans=1)
        return x0 + jnp.matmul(y, t, precision=_P_HI)

    def s_solve(r_flat):
        return s_correct(b_solve(r_flat[:, None])[:, 0])

    def s_matvec(x):
        if matvec is not None:
            bx = matvec(x)
        else:
            bx = block_tridiag_matvec(
                d_tiles, e_tiles, x.reshape(nb, m, 1)
            ).reshape(nb * m)
        return bx - jnp.matmul(
            z.T, jnp.matmul(z, x, precision=_P_HI), precision=_P_HI
        )

    x = s_correct(x0_first)
    for _ in range(n_refine):
        x = x + s_solve(rhs - s_matvec(x))
    return x


def woodbury_band_solve(d_tiles, e_tiles, z, rhs, n_refine=1):
    """Solve (B - Z^T Z) x = rhs with B block-tridiagonal PD.

    ``z``: (rz, nb*m) low-rank factor rows in the SAME flattened tile order
    as rhs; ``rhs``: (nb*m,). Returns (x, finite_ok) where x is the solution
    flattened back to (nb*m,). ``n_refine`` steps of iterative refinement
    reuse the factorization (the f32 accuracy recovery the dense path gets
    from its refinement step).
    """
    nb, m, _ = d_tiles.shape

    # Cyclic reduction for deep bands (log2(nb) batched stages instead of
    # nb sequential scan steps — the scan is latency-bound, one small
    # dependent step per tile); the scan path stays for shallow bands
    # where its lower FLOP count wins.
    use_cr = _use_cyclic_reduction(nb)
    if use_cr:
        cr = cr_factor(d_tiles, e_tiles)

        def b_solve(v_flat_cols):
            k = v_flat_cols.shape[-1]
            v = v_flat_cols.reshape(nb, m, k)
            return cr_solve(cr, v).reshape(nb * m, k)

    else:
        l_d, l_e = block_tridiag_cholesky(d_tiles, e_tiles)

        def b_solve(v_flat_cols):
            # v: (nb*m, k) -> (nb, m, k) -> solve -> back.
            k = v_flat_cols.shape[-1]
            v = v_flat_cols.reshape(nb, m, k)
            return block_tridiag_solve(l_d, l_e, v).reshape(nb * m, k)

    return _woodbury_from_bsolve(b_solve, d_tiles, e_tiles, z, rhs, n_refine)


def _dd_shard_map_solve(
    d_tiles, e_tiles, z, rhs, h, mesh, axis, n_refine, rel_scatter=None,
    gram_quads=None,
):
    """Explicit shard_map version of the domain-decomposed solve: one
    contiguous tile run per mesh device, every collective written out by
    hand (the GSPMD partitioner applied to the batched formulation chose
    multi-MB gathers of y/scatter operands — measured with
    tools/dd_hlo_probe.py — instead of the partial-sum/psum pattern).

    Cross-device traffic per solve, ALL independent of trajectory length
    per device: all_gathers of the interface tiles/rhs ((h, 384, k)), the
    Woodbury C psum (rz^2), and boundary-tile halo ppermutes in the
    refinement matvec.

    ``rel_scatter``: optional (d_dest, e_dest, pl_r, pl_c, vals) deferred
    relpose+diagonal tile updates (schur.py band assembly). Applying them
    INSIDE the shard map keeps the tile batch sharded end-to-end — the
    at-site scatter forced an all-gather of the whole (nb, 384, 384) tile
    operand (18.9 MB/iter at 1,024 poses, audited). ``vals`` are ~0.4 MB
    and ride replicated; each shard applies the updates that land in its
    tile range (mode="drop" discards the rest)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if (gram_quads is not None) != (rel_scatter is not None):
        # The negation of the gram tiles (S = rel - gram) is fused into the
        # scatter-update branch; accepting one without the other would
        # silently solve a wrong-sign system.
        raise ValueError("gram_quads and rel_scatter must be passed together")
    if gram_quads is not None:
        # Deferred mode: tiles arrive as raw (G, 6, tp, 6, tp) gram
        # quadrants; the overlap fold, negation, and relpose scatter all
        # happen inside the shard bodies (see body).
        q00, q10, q11 = gram_quads
        nb = q00.shape[0]
        m = q00.shape[1] * q00.shape[2]
        dtype = q00.dtype
    else:
        nb, m, _ = d_tiles.shape
        dtype = d_tiles.dtype
    nb_l = nb // h
    rz = z.shape[0]
    ell = nb_l * m

    if gram_quads is not None:
        tile_in = tuple(
            q.reshape(nb, m, m).reshape(h, nb_l, m, m)
            for q in (q00, q10, q11)
        )
    else:
        e_pad = jnp.concatenate(
            [e_tiles, jnp.zeros((1, m, m), dtype)], axis=0
        )
        tile_in = (
            d_tiles.reshape(h, nb_l, m, m),
            e_pad.reshape(h, nb_l, m, m),
        )
    z_dom = z.reshape(rz, h, ell)
    rhs_dom = rhs.reshape(h, ell)

    def body(*args):
        if gram_quads is not None:
            q00_s, q10_s, q11_s, z_s, r_s, *scatter_args = args
            q00_loc, q10_loc, q11_loc = q00_s[0], q10_s[0], q11_s[0]
        else:
            d_s, e_s, z_s, r_s, *scatter_args = args
            d_loc, e_loc = d_s[0], e_s[0]  # (nb_l, m, m)
        z_loc = z_s[:, 0]  # (rz, ell)
        r_loc = r_s[0]  # (ell,)
        idx = jax.lax.axis_index(axis)
        is_last = idx == h - 1
        fwd = [(i, i + 1) for i in range(h - 1)]
        bwd = [(i + 1, i) for i in range(h - 1)]
        shift_fwd = lambda x: jax.lax.ppermute(x, axis, fwd)

        if gram_quads is not None:
            # Overlap fold of the gram quadrants, domain-local: tile g's
            # diagonal sums Q00[g] + Q11[g-1]; only the FIRST tile's term
            # crosses domains (one (m, m) ppermute). The global pad group's
            # Q10 (the last domain's last coupling) is dropped, matching
            # the replicated fold's [:-1] slice.
            d_loc = q00_loc.at[1:].add(q11_loc[:-1])
            d_loc = d_loc.at[0].add(shift_fwd(q11_loc[-1]))
            e_loc = q10_loc.at[-1].multiply(
                jnp.where(is_last, 0.0, 1.0).astype(dtype)
            )

        if scatter_args:
            # Deferred relpose+diag tile updates (see docstring): negate the
            # gram tiles (S = rel - gram) and apply the updates whose
            # destination tile falls in this shard's range.
            d_dest, e_dest, pl_r, pl_c, vals = scatter_args
            d_loc = -d_loc.reshape(nb_l, 6, m // 6, 6, m // 6)
            e_loc = -e_loc.reshape(nb_l, 6, m // 6, 6, m // 6)
            ci = jnp.arange(6)
            base = idx * nb_l

            def ix(dest):
                # Out-of-range sentinel instead of dest-base directly:
                # jnp scatter indices WRAP when negative, so another
                # shard's update would alias onto a local tile.
                loc = dest - base
                loc = jnp.where((loc >= 0) & (loc < nb_l), loc, nb_l)
                return (
                    loc[:, None, None],
                    ci[None, :, None],
                    pl_r[:, None, None],
                    ci[None, None, :],
                    pl_c[:, None, None],
                )

            d_loc = d_loc.at[ix(d_dest)].add(vals, mode="drop")
            e_loc = e_loc.at[ix(e_dest)].add(vals, mode="drop")
            d_loc = d_loc.reshape(nb_l, m, m)
            e_loc = e_loc.reshape(nb_l, m, m)

        d_if, d_int = d_loc[0], d_loc[1:]
        e_first = e_loc[0]  # B[int_first, iface_own]
        e_int = e_loc[1 : nb_l - 1]
        e_last = e_loc[nb_l - 1]  # B[iface_next, int_last]; zero on last
        fac = cr_factor(d_int, e_int)
        gather = lambda x: jax.lax.all_gather(x, axis)

        # Interface-column solves (the B_IG columns of the two neighboring
        # interfaces) + interface Schur system, replicated-redundant (tiny).
        # Each shard pre-combines its OWN interface diagonal (the previous
        # domain's contribution arrives via one (m, m) ppermute) so the
        # assembly costs TWO (h, m, m) all_gathers, not four.
        ef_rhs = jnp.zeros((nb_l - 1, m, m), dtype).at[0].set(e_first)
        el_rhs = jnp.zeros((nb_l - 1, m, m), dtype).at[-1].set(e_last.T)
        y_fl = cr_solve(fac, jnp.concatenate([ef_rhs, el_rhs], axis=-1))
        yf, yl = y_fl[..., :m], y_fl[..., m:]
        sg_own = (
            d_if
            - _mm(e_first, yf[0], ta=True)
            - shift_fwd(_mm(e_last, yl[-1]))
        )
        sg_d = gather(sg_own)
        sg_e = -gather(_mm(e_last, yf[-1]))[: h - 1]
        l_sd, l_se = block_tridiag_cholesky(sg_d, sg_e)

        def b_solve_loc(v_tiles):  # (nb_l, m, k) -> (nb_l, m, k)
            k = v_tiles.shape[-1]
            u = cr_solve(fac, v_tiles[1:])
            # Pre-combine the previous domain's reduction into the OWN
            # interface rhs (one (m, k) ppermute) -> ONE (h, m, k) gather.
            rg = (
                v_tiles[0]
                - _mm(e_first, u[0], ta=True)
                - shift_fwd(_mm(e_last, u[-1]))
            )
            rg_all = gather(rg)
            g = block_tridiag_solve(l_sd, l_se, rg_all)  # (h, m, k)
            g_own = jnp.take(g, idx, axis=0)
            g_next = jnp.take(
                g, jnp.minimum(idx + 1, h - 1), axis=0
            ) * jnp.where(is_last, 0.0, 1.0).astype(dtype)
            x_int = u - _mm(yf, g_own) - _mm(yl, g_next)
            return jnp.concatenate([g_own[None], x_int], axis=0)

        v = jnp.concatenate([r_loc[:, None], z_loc.T], axis=1)
        y_all = b_solve_loc(v.reshape(nb_l, m, 1 + rz))
        x0 = y_all[..., 0].reshape(ell)
        y_loc = y_all[..., 1:].reshape(ell, rz)
        c = jnp.eye(rz, dtype=dtype) - jax.lax.psum(
            _mm(z_loc, y_loc), axis
        )
        l_c = jax.lax.linalg.cholesky(
            0.5 * (c + c.T), symmetrize_input=False
        )

        def s_correct(x):  # (ell,)
            w = jax.lax.psum(jnp.matmul(z_loc, x, precision=_P_HI), axis)
            t = solve_triangular(l_c, w, lower=True)
            t = solve_triangular(l_c, t, lower=True, trans=1)
            return x + jnp.matmul(y_loc, t, precision=_P_HI)

        def s_matvec(x):  # (ell,) domain-local B x - Z^T Z x with halos
            xt = x.reshape(nb_l, m, 1)
            out = jnp.matmul(d_loc, xt, precision=_P_HI)
            e_in = e_loc[: nb_l - 1]
            out = out.at[1:].add(
                jnp.matmul(e_in, xt[:-1], precision=_P_HI)
            )
            out = out.at[:-1].add(
                jnp.matmul(
                    jnp.swapaxes(e_in, -1, -2), xt[1:], precision=_P_HI
                )
            )
            # Cross-domain halo: my last tile's coupling feeds the NEXT
            # domain's first tile, and vice versa (non-receiving shards get
            # zeros from ppermute — exactly the boundary conditions).
            send_down = jnp.matmul(e_last, xt[-1], precision=_P_HI)
            out = out.at[0].add(jax.lax.ppermute(send_down, axis, fwd))
            x_first_next = jax.lax.ppermute(xt[0], axis, bwd)
            out = out.at[-1].add(
                jnp.matmul(
                    jnp.swapaxes(e_last, -1, -2), x_first_next,
                    precision=_P_HI,
                )
            )
            bx = out.reshape(ell)
            zx = jax.lax.psum(jnp.matmul(z_loc, x, precision=_P_HI), axis)
            return bx - jnp.matmul(z_loc.T, zx, precision=_P_HI)

        x = s_correct(x0)
        for _ in range(n_refine):
            r = r_loc - s_matvec(x)
            x = x + s_correct(
                b_solve_loc(r.reshape(nb_l, m, 1))[..., 0].reshape(ell)
            )
        return x[None]

    extra = tuple(rel_scatter) if rel_scatter is not None else ()
    out = shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(P(axis) for _ in tile_in)
        + (P(None, axis, None), P(axis, None))
        + tuple(P() for _ in extra),  # scatter updates ride replicated
        out_specs=P(axis, None),
        check_vma=False,
    )(*tile_in, z_dom, rhs_dom, *extra)
    return out.reshape(nb * m)


def dd_woodbury_band_solve(
    d_tiles, e_tiles, z, rhs, n_domains, n_refine=1,
    shard_mesh=None, shard_axis=None, rel_scatter=None, gram_quads=None,
):
    """Trajectory-domain-decomposed Woodbury band solve (multi-host path).

    Same system as woodbury_band_solve — (B - Z^T Z) x = rhs with B
    block-tridiagonal PD — but B is partitioned into ``n_domains``
    CONTIGUOUS runs of nb/n_domains pose tiles (substructuring / SPIKE):

      - the FIRST tile of each domain is an INTERFACE tile; the rest are
        that domain's INTERIOR (a smaller block-tridiagonal system with no
        cross-domain coupling);
      - interiors factor and solve BATCHED over the domain axis — under a
        domain-axis sharding these ops are embarrassingly parallel, so each
        device touches only its own tiles (the replicated CR path
        all-gathers every level batch each iteration);
      - the interface Schur complement S_G = B_GG - B_GI B_II^-1 B_IG is a
        TINY block-tridiagonal system over the n_domains interface tiles
        ((H, 384, 384) ~ 0.6 MB/host to combine) solved replicated;
      - interiors back-substitute locally from their two interface values.

    Cross-host traffic per solve: the S_G/interface-rhs combine + the
    Woodbury C = I - Z Y psum (rz^2) + halo exchange in the refinement
    matvec — all independent of trajectory length per host.

    ``shard_mesh``/``shard_axis``: optional sharding constraints pinning the
    domain axis to mesh devices (XLA then keeps interior work device-local
    and inserts collectives only at the interface/C combines).
    """
    nb = (gram_quads[0] if gram_quads is not None else d_tiles).shape[0]
    h = int(n_domains)
    if nb % h != 0 or nb // h < 2:
        raise ValueError(
            f"n_domains={h} needs nb % h == 0 and >=2 tiles/domain (nb={nb})"
        )
    if (
        shard_mesh is not None
        and shard_axis is not None
        and h > 1
        and h == int(shard_mesh.devices.size)
    ):
        # One domain per mesh device: run the explicit shard_map version —
        # hand-written collectives instead of partitioner guesses.
        return _dd_shard_map_solve(
            d_tiles, e_tiles, z, rhs, h, shard_mesh, shard_axis, n_refine,
            rel_scatter=rel_scatter, gram_quads=gram_quads,
        )
    if rel_scatter is not None or gram_quads is not None:
        raise ValueError(
            "deferred tile updates / gram quadrants require the shard_map "
            "path: n_domains must equal the mesh device count"
        )
    m = d_tiles.shape[1]
    nb_l = nb // h
    dtype = d_tiles.dtype

    def cst(x, axis=0):
        if shard_mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        spec = [None] * x.ndim
        spec[axis] = shard_axis
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(shard_mesh, PartitionSpec(*spec))
        )

    d_dom = cst(d_tiles.reshape(h, nb_l, m, m))
    e_pad = jnp.concatenate(
        [e_tiles, jnp.zeros((1, m, m), dtype)], axis=0
    )
    # e_dom[d, j] = B[tile d*nb_l+j+1, tile d*nb_l+j]:
    #   j=0         -> interface_d  -> its interior's first tile
    #   j=1..nb_l-2 -> interior-internal couplings
    #   j=nb_l-1    -> interior's last tile -> interface_{d+1} (zero pad for
    #                  the last domain)
    e_dom = cst(e_pad.reshape(h, nb_l, m, m))
    d_if = d_dom[:, 0]
    d_int = d_dom[:, 1:]
    e_first = e_dom[:, 0]  # B[int_first_d, iface_d]
    e_int = e_dom[:, 1 : nb_l - 1]
    e_last = e_dom[:, nb_l - 1]  # B[iface_{d+1}, int_last_d]

    fac = jax.vmap(cr_factor)(d_int, e_int)
    bsolve_int = jax.vmap(cr_solve)

    # Interface-column solves: Yf = B_int^-1 (E_f at first tile),
    # Yl = B_int^-1 (E_l^T at last tile) — the B_IG columns of each
    # domain's two neighboring interfaces.
    ef_rhs = jnp.zeros((h, nb_l - 1, m, m), dtype).at[:, 0].set(e_first)
    el_rhs = (
        jnp.zeros((h, nb_l - 1, m, m), dtype)
        .at[:, -1]
        .set(jnp.swapaxes(e_last, -1, -2))
    )
    y_fl = bsolve_int(fac, cst(jnp.concatenate([ef_rhs, el_rhs], axis=-1)))
    yf, yl = y_fl[..., :m], y_fl[..., m:]

    # Interface Schur complement: block-tridiagonal over the h interface
    # tiles. Right term via each domain's own interior, left term via the
    # previous domain's interior (shifted), cross term couples consecutive
    # interfaces through the interior between them.
    c_right = jnp.matmul(
        jnp.swapaxes(e_first, -1, -2), yf[:, 0], precision=_P_HI
    )
    c_left = jnp.matmul(e_last, yl[:, -1], precision=_P_HI)
    sg_d = d_if - c_right
    sg_d = sg_d.at[1:].add(-c_left[:-1])
    sg_e = -jnp.matmul(e_last, yf[:, -1], precision=_P_HI)[: h - 1]
    l_sd, l_se = block_tridiag_cholesky(sg_d, sg_e)

    def b_solve(v_flat_cols):
        k = v_flat_cols.shape[-1]
        vd = cst(v_flat_cols.reshape(h, nb_l, m, k))
        v_if = vd[:, 0]
        v_int = vd[:, 1:]
        u = bsolve_int(fac, v_int)  # (h, nb_l-1, m, k)
        r_g = v_if - jnp.matmul(
            jnp.swapaxes(e_first, -1, -2), u[:, 0], precision=_P_HI
        )
        r_g = r_g.at[1:].add(
            -jnp.matmul(e_last[:-1], u[:-1, -1], precision=_P_HI)
        )
        g = block_tridiag_solve(l_sd, l_se, r_g)  # (h, m, k)
        g_next = jnp.concatenate(
            [g[1:], jnp.zeros((1, m, k), dtype)], axis=0
        )
        x_int = (
            u
            - jnp.matmul(yf, g[:, None], precision=_P_HI)
            - jnp.matmul(yl, g_next[:, None], precision=_P_HI)
        )
        x = jnp.concatenate([g[:, None], x_int], axis=1)
        return x.reshape(nb * m, k)

    def dd_matvec(x_flat):
        """B x with the domain layout: within-domain contributions are
        batched and device-local; the cross-domain couplings touch only
        each domain's boundary tiles (a halo exchange, not a tile-batch
        all-gather — the replicated matvec forced XLA to re-gather the full
        tile batch every refinement step)."""
        xd = cst(x_flat.reshape(h, nb_l, m, 1))
        out = jnp.matmul(d_dom, xd, precision=_P_HI)
        e_in = e_dom[:, : nb_l - 1]
        out = out.at[:, 1:].add(
            jnp.matmul(e_in, xd[:, : nb_l - 1], precision=_P_HI)
        )
        out = out.at[:, : nb_l - 1].add(
            jnp.matmul(
                jnp.swapaxes(e_in, -1, -2), xd[:, 1:], precision=_P_HI
            )
        )
        # Cross-domain couplings: e_dom[d, -1] links (d, last) <-> (d+1, 0).
        out = out.at[1:, 0].add(
            jnp.matmul(e_dom[:-1, -1], xd[:-1, -1], precision=_P_HI)
        )
        out = out.at[:-1, -1].add(
            jnp.matmul(
                jnp.swapaxes(e_dom[:-1, -1], -1, -2), xd[1:, 0],
                precision=_P_HI,
            )
        )
        return out.reshape(nb * m)

    return _woodbury_from_bsolve(
        b_solve, d_tiles, e_tiles, z, rhs, n_refine, matvec=dd_matvec
    )
