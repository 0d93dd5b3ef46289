"""Device chaining: the DP score-fill as a batched lax.scan kernel.

The reference fills f[]/p[] with a per-anchor backward scan over up to
max_iter predecessors (reference: mg_lchain_dp, lchain.c:439-505).  Here the
whole predecessor window is scored *vectorized* per step — a [B, W] tensor op
— while the anchor dimension advances through a lax.scan whose carry is a
W-slot ring buffer of recent anchors.  Backtracking runs over the (f, p)
arrays on the host (chain/host.py:chain_backtrack) or on the device
(chain/backtrack_device.py).  This scan is the CPU path and the oracle of
the GPU kernel in chain/pallas_fill.py.

Anchors arrive as three uint32/int32 planes (JAX runs without 64-bit ints
by default):
    key  = rev<<31 | tid      (the reference's x>>32)
    tpos = target position    (low 32 bits of x)
    qpos = query position     (low 32 bits of y; span is constant per run)

Deviations from the reference, both documented in SURVEY.md hard-parts:
  * the max_skip/t[] pruning heuristic is dropped — it exists only to bound
    CPU time and can only *miss* predecessors; the kernel always scores the
    full window, so chains score >= the reference's.
  * ties on the best predecessor resolve to the largest j, which is exactly
    the reference's first-strict-improvement-scanning-descending rule.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# numpy, NOT jnp: a module-level jax.Array is a device constant whose
# lowering-time embedding costs a D2H fetch
INT32_MIN = np.int32(-(2**31))


def mg_log2_jnp(x):
    """Bit-twiddled fast log2, bit-identical to the reference
    (lchain.c:23-31)."""
    z = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    log_2 = (((z >> jnp.uint32(23)) & jnp.uint32(255)).astype(jnp.int32) - 128).astype(
        jnp.float32
    )
    z = (z & jnp.uint32(~(255 << 23) & 0xFFFFFFFF)) + jnp.uint32(127 << 23)
    zf = jax.lax.bitcast_convert_type(z, jnp.float32)
    return log_2 + (
        (jnp.float32(-0.34484843) * zf + jnp.float32(2.02466578)) * zf
        - jnp.float32(0.67487759)
    )


def _window_scores(
    key_i, tpos_i, qpos_i, r_key, r_tpos, r_qpos, r_f, j_valid,
    q_span, max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip,
):
    """Vectorized compute_score over the ring window
    (reference: compute_score, lchain.c:297-356). Returns (total [B,W] i32,
    in_band [B,W]) where total = score + f[j], INT32_MIN when invalid."""
    dq = qpos_i[:, None] - r_qpos
    dr = tpos_i[:, None] - r_tpos
    in_band = j_valid & (r_key == key_i[:, None]) & (dr <= max_dist_t) & (dr >= 0)
    dd = jnp.abs(dr - dq)
    ok = (
        in_band
        & (dq > 0)
        & (dq <= max_dist_q)
        & (dr != 0)
        & (dd <= bw)
        & (dr <= max_dist_q)
    )
    dg = jnp.minimum(dr, dq)
    sc = jnp.minimum(q_span, dg)
    lin_pen = jnp.float32(chn_pen_gap) * dd.astype(jnp.float32) + jnp.float32(
        chn_pen_skip
    ) * dg.astype(jnp.float32)
    log_pen = jnp.where(dd >= 1, mg_log2_jnp((dd + 1).astype(jnp.float32)), 0.0)
    pen = (lin_pen + jnp.float32(0.5) * log_pen).astype(jnp.int32)
    sc = jnp.where((dd != 0) | (dg > q_span), sc - pen, sc)
    total = jnp.where(ok, sc + r_f, INT32_MIN)
    return total, in_band


@functools.partial(
    jax.jit,
    static_argnames=(
        "q_span", "max_dist_t", "max_dist_q", "bw", "max_iter",
        "chn_pen_gap", "chn_pen_skip",
    ),
)
def chain_fill_batch(
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
):
    """Fill (f, p) for every anchor of every read in the batch.

    Returns f [B,N] i32 (best chain score ending at each anchor) and
    p [B,N] i32 (best predecessor index, -1 if none)."""
    b, n = key.shape
    w = max_iter
    if max_dist_t < bw:
        max_dist_t = bw
    if max_dist_q < bw:
        max_dist_q = bw

    slots = jnp.arange(w, dtype=jnp.int32)  # ring slot ids

    def step(carry, xs):
        r_key, r_tpos, r_qpos, r_f, mii_idx, mii_key, mii_tpos, mii_qpos, mii_f = carry
        i, k_i, t_i, q_i, alive = xs

        # absolute anchor index held by each ring slot: j == slot (mod w),
        # i-w <= j < i
        j_abs = (i - 1) - ((i - 1 - slots) % w)
        j_valid = (j_abs[None, :] >= 0) & (j_abs[None, :] < n_anchors[:, None])
        j_abs_b = jnp.broadcast_to(j_abs[None, :], (b, w))

        total, in_band = _window_scores(
            k_i, t_i, q_i, r_key, r_tpos, r_qpos, r_f, j_valid,
            q_span, max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip,
        )
        best = jnp.max(total, axis=1)
        best_j = jnp.max(jnp.where(total == best[:, None], j_abs_b, -1), axis=1)
        max_f = jnp.where(best > q_span, best, q_span)
        max_j = jnp.where(best > q_span, best_j, -1)

        # banded out-of-window shortcut (reference: lchain.c:473-503)
        n_inband = jnp.sum(in_band, axis=1).astype(jnp.int32)
        st = i - n_inband
        stale = (
            (mii_idx < 0)
            | (mii_key != k_i)
            | ((t_i - mii_tpos) > max_dist_t)
            | (t_i < mii_tpos)
        )
        fb = jnp.where(in_band, r_f, INT32_MIN)
        re_best = jnp.max(fb, axis=1)
        re_j = jnp.max(jnp.where(fb == re_best[:, None], j_abs_b, -1), axis=1)
        has = re_best > INT32_MIN
        mii_idx2 = jnp.where(stale, jnp.where(has, re_j, -1), mii_idx)
        # take fields of the recomputed max_ii (the slot holding re_j)
        re_slot = jnp.argmax(
            jnp.where(fb == re_best[:, None], j_abs_b, -1), axis=1
        )
        take = lambda ring: jnp.take_along_axis(ring, re_slot[:, None], axis=1)[:, 0]
        mii_key2 = jnp.where(stale & has, take(r_key), mii_key)
        mii_tpos2 = jnp.where(stale & has, take(r_tpos), mii_tpos)
        mii_qpos2 = jnp.where(stale & has, take(r_qpos), mii_qpos)
        mii_f2 = jnp.where(stale & has, take(r_f), mii_f)

        # score against max_ii when it sits before the examined window
        use_mii = (mii_idx2 >= 0) & (mii_idx2 < st)
        dq = q_i - mii_qpos2
        dr = t_i - mii_tpos2
        dd = jnp.abs(dr - dq)
        dg = jnp.minimum(dr, dq)
        ok = (
            use_mii
            & (mii_key2 == k_i)
            & (dq > 0) & (dq <= max_dist_q)
            & (dr != 0) & (dr > 0) & (dr <= max_dist_t)
            & (dd <= bw) & (dr <= max_dist_q)
        )
        scm = jnp.minimum(q_span, dg)
        lin = jnp.float32(chn_pen_gap) * dd.astype(jnp.float32) + jnp.float32(
            chn_pen_skip
        ) * dg.astype(jnp.float32)
        logp = jnp.where(dd >= 1, mg_log2_jnp((dd + 1).astype(jnp.float32)), 0.0)
        scm = jnp.where(
            (dd != 0) | (dg > q_span),
            scm - (lin + jnp.float32(0.5) * logp).astype(jnp.int32),
            scm,
        )
        cand = jnp.where(ok, scm + mii_f2, INT32_MIN)
        better = ok & (cand > max_f)
        max_f = jnp.where(better, cand, max_f)
        max_j = jnp.where(better, mii_idx2, max_j)

        f_i = max_f.astype(jnp.int32)
        # advance max_ii to i when i dominates (reference: lchain.c:503)
        adv = (mii_idx2 < 0) | (
            (mii_key2 == k_i) & (t_i >= mii_tpos2)
            & ((t_i - mii_tpos2) <= max_dist_t) & (mii_f2 < f_i)
        )
        mii_idx3 = jnp.where(adv & alive, i, mii_idx2)
        mii_key3 = jnp.where(adv & alive, k_i, mii_key2)
        mii_tpos3 = jnp.where(adv & alive, t_i, mii_tpos2)
        mii_qpos3 = jnp.where(adv & alive, q_i, mii_qpos2)
        mii_f3 = jnp.where(adv & alive, f_i, mii_f2)

        # write anchor i into its ring slot
        slot = i % w
        r_key = r_key.at[:, slot].set(jnp.where(alive, k_i, r_key[:, slot]))
        r_tpos = r_tpos.at[:, slot].set(jnp.where(alive, t_i, r_tpos[:, slot]))
        r_qpos = r_qpos.at[:, slot].set(jnp.where(alive, q_i, r_qpos[:, slot]))
        r_f = r_f.at[:, slot].set(jnp.where(alive, f_i, r_f[:, slot]))

        out_f = jnp.where(alive, f_i, 0)
        out_p = jnp.where(alive, max_j, -1).astype(jnp.int32)
        return (
            r_key, r_tpos, r_qpos, r_f,
            mii_idx3, mii_key3, mii_tpos3, mii_qpos3, mii_f3,
        ), (out_f, out_p)

    init = (
        jnp.zeros((b, w), jnp.uint32),
        jnp.zeros((b, w), jnp.int32),
        jnp.zeros((b, w), jnp.int32),
        jnp.full((b, w), INT32_MIN, jnp.int32),
        jnp.full(b, -1, jnp.int32),
        jnp.zeros(b, jnp.uint32),
        jnp.zeros(b, jnp.int32),
        jnp.zeros(b, jnp.int32),
        jnp.full(b, INT32_MIN, jnp.int32),
    )
    idxs = jnp.arange(n, dtype=jnp.int32)
    xs = (
        idxs,
        jnp.swapaxes(key, 0, 1),
        jnp.swapaxes(tpos, 0, 1),
        jnp.swapaxes(qpos, 0, 1),
        jnp.swapaxes(idxs[None, :] < n_anchors[:, None], 0, 1),
    )
    _, (f, p) = jax.lax.scan(step, init, xs)
    return jnp.swapaxes(f, 0, 1), jnp.swapaxes(p, 0, 1)
