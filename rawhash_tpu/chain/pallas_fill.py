"""Chaining DP score-fill as a Pallas kernel through the Triton route (GPU).

Same recurrence as chain/device.py::chain_fill_batch (reference:
mg_lchain_dp, lchain.c:439-505, minus the max_skip pruning — documented
deviation), but the whole anchor loop of one read runs inside one program:

  * grid: one program per read, so a batch of 256 reads gives 256 blocks
    (the H100 has 132 SMs); programs run in parallel and share nothing
  * the predecessor window (max_iter slots, padded to a power of two) lies
    across the block's threads; the ring of recent anchors' key, tpos, qpos
    and f stays in registers as fori_loop carries, where the lax.scan
    version moves it through device memory at every anchor step
  * the next anchor's planes are loaded one step ahead, so the load latency
    hides behind the current step's window scoring
  * only anchors below the read's n_anchors are visited; the wrapper masks
    the rest of the outputs (f = 0, p = -1, as the scan writes them)

The lax.scan implementation remains the oracle and the CPU path; tests run
this kernel in interpret mode and assert bit-identical (f, p).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .device import mg_log2_jnp

INT32_MIN = -(2**31)  # python int: kernels cannot capture jnp array constants

# warps per program: the window reductions are each step's critical path,
# and one warp (8 slots per thread, shuffle-only reductions) measured
# fastest of 1/2/4/8 on the H100 (PERF.md)
NUM_WARPS = 1


def _penalty(dd, dg, gap, skip):
    """compute_score's gap penalty (lchain.c:316-322) on a [W] window."""
    lin = jnp.float32(gap) * dd.astype(jnp.float32)
    if skip:
        lin = lin + jnp.float32(skip) * dg.astype(jnp.float32)
    log_pen = jnp.where(dd >= 1, mg_log2_jnp((dd + 1).astype(jnp.float32)), 0.0)
    return (lin + jnp.float32(0.5) * log_pen).astype(jnp.int32)


def _fill_kernel(
    key_ref, tpos_ref, qpos_ref, n_ref, f_ref, p_ref,
    *, w: int, wp: int, q_span: int, max_dist_t: int, max_dist_q: int,
    bw: int, gap: float, skip: float,
):
    r = pl.program_id(0)
    n_last = key_ref.shape[1] - 1
    n_r = n_ref[r]
    slots = jax.lax.broadcasted_iota(jnp.int32, (wp,), 0)
    in_ring = slots < w

    def anchor(i):
        j = jnp.minimum(i, n_last)
        return key_ref[r, j], tpos_ref[r, j], qpos_ref[r, j]

    def body(i, carry):
        (rk, rt, rq, rf, mii_idx, mii_key, mii_tpos, mii_qpos, mii_f,
         k_i, t_i, q_i) = carry
        k_n, t_n, q_n = anchor(i + 1)  # prefetch the next step's anchor

        # absolute anchor index held by each ring slot: j == slot (mod w),
        # i-w <= j < i (the operand of rem is >= 0 on live slots)
        j_abs = jnp.where(
            in_ring, (i - 1) - jax.lax.rem(i - 1 - slots + w, w), -1
        )
        j_valid = j_abs >= 0

        # window scores (reference: compute_score, lchain.c:297-356)
        dq = q_i - rq
        dr = t_i - rt
        in_band = j_valid & (rk == k_i) & (dr <= max_dist_t) & (dr >= 0)
        dd = jnp.abs(dr - dq)
        ok = (
            in_band & (dq > 0) & (dq <= max_dist_q) & (dr != 0)
            & (dd <= bw) & (dr <= max_dist_q)
        )
        dg = jnp.minimum(dr, dq)
        sc = jnp.minimum(q_span, dg)
        sc = jnp.where(
            (dd != 0) | (dg > q_span),
            sc - _penalty(dd, dg, gap, skip), sc,
        )
        total = jnp.where(ok, sc + rf, INT32_MIN)
        best = jnp.max(total)
        best_j = jnp.max(jnp.where(total == best, j_abs, -1))
        max_f = jnp.where(best > q_span, best, q_span)
        max_j = jnp.where(best > q_span, best_j, -1)

        # banded out-of-window shortcut (reference: lchain.c:473-503)
        n_inband = jnp.sum(in_band.astype(jnp.int32))
        st = i - n_inband
        stale = (
            (mii_idx < 0) | (mii_key != k_i)
            | ((t_i - mii_tpos) > max_dist_t) | (t_i < mii_tpos)
        )
        fb = jnp.where(in_band, rf, INT32_MIN)
        re_best = jnp.max(fb)
        re_j = jnp.max(jnp.where(fb == re_best, j_abs, -1))
        has = re_best > INT32_MIN
        upd = stale & has
        mii_idx2 = jnp.where(stale, jnp.where(has, re_j, -1), mii_idx)
        # the recomputed max_ii is in band, so its key is k_i and its f is
        # re_best; only tpos and qpos need a pick from the ring
        sel = j_abs == re_j
        mii_key2 = jnp.where(upd, k_i, mii_key)
        mii_tpos2 = jnp.where(upd, jnp.max(jnp.where(sel, rt, INT32_MIN)), mii_tpos)
        mii_qpos2 = jnp.where(upd, jnp.max(jnp.where(sel, rq, INT32_MIN)), mii_qpos)
        mii_f2 = jnp.where(upd, re_best, mii_f)

        # score against max_ii when it precedes the examined window
        dqm = q_i - mii_qpos2
        drm = t_i - mii_tpos2
        ddm = jnp.abs(drm - dqm)
        dgm = jnp.minimum(drm, dqm)
        okm = (
            (mii_idx2 >= 0) & (mii_idx2 < st) & (mii_key2 == k_i)
            & (dqm > 0) & (dqm <= max_dist_q)
            & (drm > 0) & (drm <= max_dist_t)
            & (ddm <= bw) & (drm <= max_dist_q)
        )
        scm = jnp.minimum(q_span, dgm)
        scm = jnp.where(
            (ddm != 0) | (dgm > q_span),
            scm - _penalty(ddm, dgm, gap, skip), scm,
        )
        cand = jnp.where(okm, scm + mii_f2, INT32_MIN)
        better = okm & (cand > max_f)
        f_i = jnp.where(better, cand, max_f)
        max_j = jnp.where(better, mii_idx2, max_j)

        # advance max_ii to i when i dominates (reference: lchain.c:503)
        adv = (mii_idx2 < 0) | (
            (mii_key2 == k_i) & (t_i >= mii_tpos2)
            & ((t_i - mii_tpos2) <= max_dist_t) & (mii_f2 < f_i)
        )
        mii = (
            jnp.where(adv, i, mii_idx2), jnp.where(adv, k_i, mii_key2),
            jnp.where(adv, t_i, mii_tpos2), jnp.where(adv, q_i, mii_qpos2),
            jnp.where(adv, f_i, mii_f2),
        )

        f_ref[r, i] = f_i
        p_ref[r, i] = max_j
        put = slots == jax.lax.rem(i, w)
        ring = (
            jnp.where(put, k_i, rk), jnp.where(put, t_i, rt),
            jnp.where(put, q_i, rq), jnp.where(put, f_i, rf),
        )
        return (*ring, *mii, k_n, t_n, q_n)

    zeros = jnp.zeros((wp,), jnp.int32)
    init = (
        zeros, zeros, zeros, jnp.full((wp,), INT32_MIN, jnp.int32),
        jnp.int32(-1), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        jnp.int32(INT32_MIN),
        *anchor(0),
    )
    jax.lax.fori_loop(0, n_r, body, init)


@functools.partial(
    jax.jit,
    static_argnames=(
        "q_span", "max_dist_t", "max_dist_q", "bw", "max_iter",
        "chn_pen_gap", "chn_pen_skip", "num_warps", "interpret",
    ),
)
def chain_fill_pallas(
    key: jnp.ndarray,  # u32 [B, N]
    tpos: jnp.ndarray,  # i32 [B, N]
    qpos: jnp.ndarray,  # i32 [B, N]
    n_anchors: jnp.ndarray,  # i32 [B]
    *,
    q_span: int,
    max_dist_t: int,
    max_dist_q: int,
    bw: int,
    max_iter: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
):
    """Drop-in replacement for chain_fill_batch (same outputs, bit-exact)."""
    b, n = key.shape
    max_dist_t = max(max_dist_t, bw)
    max_dist_q = max(max_dist_q, bw)
    kern = functools.partial(
        _fill_kernel,
        w=max_iter, wp=pl.next_power_of_2(max_iter), q_span=q_span,
        max_dist_t=max_dist_t, max_dist_q=max_dist_q, bw=bw,
        gap=chn_pen_gap, skip=chn_pen_skip,
    )
    n_anchors = jnp.minimum(n_anchors.astype(jnp.int32), n)
    f, p = pl.pallas_call(
        kern,
        grid=(b,),
        out_shape=[
            jax.ShapeDtypeStruct((b, n), jnp.int32),
            jax.ShapeDtypeStruct((b, n), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        backend="triton",
        interpret=interpret,
        name="chain_fill",
    )(jax.lax.bitcast_convert_type(key, jnp.int32), tpos, qpos, n_anchors)
    live = jnp.arange(n, dtype=jnp.int32)[None, :] < n_anchors[:, None]
    return jnp.where(live, f, 0), jnp.where(live, p, -1)
