"""Batched event detection on device (JAX/XLA).

Re-architects the reference's per-read scalar segmentation chain
(reference: src/revent.c) as fixed-shape batched tensor ops over a
[B, chunk_len] padded signal batch:

  * streaming z-normalization with (sum, sum_sq, n) carried across chunks —
    masked reductions + elementwise (reference: normalize_signal:221-255)
  * +/-3 sigma clip followed by dense compaction — mask + cumsum scatter
  * prefix sums & two-window t-statistics — cumsum + shifted gathers
    (reference: comp_prefix_prefixsq:23-36, comp_tstat:38-74)
  * the dual peak-detector state machine — a lax.scan over signal positions
    with a [B]-wide detector state, vmapped across the batch "for free"
    (reference: gen_peaks:91-150)
  * IQR-filtered segment means — a per-row (segment_id, value) lexicographic
    sort, quartile gathers, and masked scatter-add
    (reference: calculate_mean_of_filtered_segment:158-180, gen_events:193-219)

Shapes are static everywhere; validity is carried in masks and counts, never
in data-dependent shapes, so the whole chunk step jits into one XLA program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FLT_MIN = np.float32(1.1754943508222875e-38)  # numpy scalars: inline as
FLT_MAX = np.float32(3.4028234663852886e38)  # literals (no const hoisting)
# numpy, NOT jnp: a module-level jax.Array is a device constant, and
# embedding it at lowering time forces a D2H fetch (it also trips the jax
# 0.9.0 fastpath hoisted-constant bug, see device_step.py)
BIG_I32 = np.int32(0x7FFFFFFF)


class NormCarry(NamedTuple):
    """Running normalization state per read (reference: rmap.cpp:412-421)."""

    sum: jnp.ndarray  # f32 [B]
    sum_sq: jnp.ndarray  # f32 [B]
    n: jnp.ndarray  # i32 [B]

    @staticmethod
    def zeros(batch: int):
        return NormCarry(
            jnp.zeros(batch, jnp.float32),
            jnp.zeros(batch, jnp.float32),
            jnp.zeros(batch, jnp.int32),
        )


def dense_compact(values: jnp.ndarray, keep: jnp.ndarray):
    """Row-wise stable compaction of `values[B, L]` under boolean `keep`.

    Returns (compacted [B, L] zero-padded, counts [B])."""
    b, l = values.shape
    idx = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    tgt = jnp.where(keep, idx, l)
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, l), 0)
    out = jnp.zeros((b, l + 1), values.dtype).at[rows, tgt].set(values, mode="drop")
    return out[:, :l], jnp.sum(keep, axis=1).astype(jnp.int32)


def _shift_right(x, w: int):
    """y[:, i] = x[:, max(i - w, 0)] without a gather (pure pad+slice,
    which fuses; a per-row take_along_axis gather does not)."""
    return jnp.concatenate([jnp.repeat(x[:, :1], w, axis=1), x[:, :-w]], axis=1)


def _shift_left(x, w: int):
    """y[:, i] = x[:, min(i + w, last)] without a gather."""
    return jnp.concatenate([x[:, w:], jnp.repeat(x[:, -1:], w, axis=1)], axis=1)


def _tstat(prefix, prefix_sq, n_sig, w: int):
    """t-stat over two adjacent w-windows; zero outside [w, n_sig - w]
    (reference: comp_tstat, revent.c:38-74).  All window lookups are uniform
    shifts of the prefix arrays, so they lower to slices, not gathers."""
    b, lp1 = prefix.shape
    l = lp1 - 1
    i = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    p_i = prefix[:, :l]
    p_im = _shift_right(prefix, w)[:, :l]
    p_ip = _shift_left(prefix, w)[:, :l]
    q_i = prefix_sq[:, :l]
    q_im = _shift_right(prefix_sq, w)[:, :l]
    q_ip = _shift_left(prefix_sq, w)[:, :l]
    sum1 = jnp.where(i > w, p_i - p_im, p_i)
    sumsq1 = jnp.where(i > w, q_i - q_im, q_i)
    sum2 = p_ip - p_i
    sumsq2 = q_ip - q_i
    wf = jnp.float32(w)
    mean1 = sum1 / wf
    mean2 = sum2 / wf
    var = (sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2) / wf
    var = jnp.maximum(var, FLT_MIN)
    t = jnp.abs(mean2 - mean1) / jnp.sqrt(var)
    valid = (i >= w) & (i <= n_sig[:, None] - w) & (n_sig[:, None] >= 2 * w)
    return jnp.where(valid, t, 0.0)


def _detector_step(cur, i, state, active, threshold, wl: int, peak_height):
    """One position update of a single peak detector, [B]-vectorized
    (reference: gen_peaks, revent.c:107-145)."""
    peak_pos, peak_val, valid = state
    in_peak = peak_pos >= 0

    # CASE 1: no recorded maximum yet
    c1_deeper = cur < peak_val
    c1_rise = (~c1_deeper) & ((cur - peak_val) > peak_height)
    pv1 = jnp.where(c1_deeper | c1_rise, cur, peak_val)
    pp1 = jnp.where(c1_rise, i, peak_pos)

    # CASE 2: inside a candidate peak
    c2_higher = cur > peak_val
    pv2 = jnp.where(c2_higher, cur, peak_val)
    pp2 = jnp.where(c2_higher, i, peak_pos)
    above = pv2 > threshold
    set_valid = ((pv2 - cur) > peak_height) & above
    valid2 = valid | set_valid
    emit = valid2 & ((i - pp2) > (wl // 2))
    pv2e = jnp.where(emit, cur, pv2)
    pp2e = jnp.where(emit, jnp.int32(-1), pp2)
    valid2e = valid2 & (~emit)

    new_pp = jnp.where(in_peak, pp2e, pp1)
    new_pv = jnp.where(in_peak, pv2e, pv1)
    new_valid = jnp.where(in_peak, valid2e, valid)

    new_pp = jnp.where(active, new_pp, peak_pos)
    new_pv = jnp.where(active, new_pv, peak_val)
    new_valid = jnp.where(active, new_valid, valid)

    emit_pos = jnp.where(active & in_peak & emit, pp2, jnp.int32(-1))
    mask_signal = active & in_peak & above  # short detector masks later ones
    mask_pos = pp2
    return (new_pp, new_pv, new_valid), emit_pos, mask_signal, mask_pos


def _gen_peaks(tstat1, tstat2, n_sig, t1, t2, w1: int, w2: int, peak_height):
    """Scan the dual-detector state machine over signal positions; returns
    emitted peak positions [B, 2L] in emission order (-1 = no emission)."""
    b, l = tstat1.shape
    t1f, t2f = jnp.float32(t1), jnp.float32(t2)
    ph = jnp.float32(peak_height)

    init = (
        jnp.zeros(b, jnp.int32),  # masked_to det1 (det0's is never written)
        (jnp.full(b, -1, jnp.int32), jnp.full(b, FLT_MAX), jnp.zeros(b, bool)),
        (jnp.full(b, -1, jnp.int32), jnp.full(b, FLT_MAX), jnp.zeros(b, bool)),
    )

    def step(carry, xs):
        masked_to1, st0, st1 = carry
        i, cur0, cur1 = xs
        alive = i < n_sig
        # detector 0 (short): masked_to stays 0, so active from i >= 1 on
        act0 = alive & (0 < i)
        st0, emit0, msk, mpos = _detector_step(cur0, i, st0, act0, t1f, w1, ph)
        # short detector resets+masks the long one (reference: revent.c:125-131)
        new_masked = jnp.where(msk, mpos + jnp.int32(w1), masked_to1)
        pp1, pv1, va1 = st1
        st1 = (
            jnp.where(msk, jnp.int32(-1), pp1),
            jnp.where(msk, FLT_MAX, pv1),
            jnp.where(msk, False, va1),
        )
        act1 = alive & (new_masked < i)
        st1, emit1, _, _ = _detector_step(cur1, i, st1, act1, t2f, w2, ph)
        return (new_masked, st0, st1), jnp.stack([emit0, emit1], axis=-1)

    xs = (
        jnp.arange(l, dtype=jnp.int32),
        jnp.swapaxes(tstat1, 0, 1),
        jnp.swapaxes(tstat2, 0, 1),
    )
    # NOTE: unrolling this scan looked attractive but measured slower at
    # production batch sizes and blew compile time up 5x; keep unroll=1
    _, emits = jax.lax.scan(step, init, xs)  # [L, B, 2]
    return jnp.swapaxes(emits, 0, 1).reshape(b, 2 * l)


def _segment_events(norm, n_sig, emitted, emit_ok, n_peaks, e_cap: int):
    """Events = IQR-filtered means of the segments between consecutive peaks
    (reference: gen_events + calculate_mean_of_filtered_segment).

    `emitted`/`emit_ok` are the raw peak emissions [B, 2L].  Plan
    (per-row gathers/scatters are the expensive ops, so each appears at
    most once and at the smallest width):
      * per-element segment id = running count of peaks at-or-before the
        position: ONE indicator scatter + cumsum (a vmapped searchsorted is
        ~13 gather levels, ~8x slower)
      * segment boundaries computed arithmetically from the sorted peak
        positions (segments are contiguous position ranges) — no count
        scatter
      * IQR bounds fetched with ONE packed [B, E+1, 2] gather (two separate
        bound gathers measured 4.4x slower)
      * per-segment sums/counts as prefix-sum differences over the
        (segment, value)-sorted row — no scatter-adds"""
    b, l = norm.shape
    n_ev = jnp.minimum(n_peaks, e_cap)

    pos = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    # seg[p] = #{emitted peaks <= p}  (searchsorted(sorted_peaks, p, 'right'))
    erows = jax.lax.broadcasted_iota(jnp.int32, emitted.shape, 0)
    ind = (
        jnp.zeros((b, l + 1), jnp.int32)
        .at[erows, jnp.where(emit_ok, jnp.minimum(emitted, l), l)]
        .add(1, mode="drop")[:, :l]
    )
    seg = jnp.cumsum(ind, axis=1)
    invalid = (seg >= n_ev[:, None]) | (pos >= n_sig[:, None])
    seg = jnp.where(invalid, e_cap, seg)

    # per-row (segment major, value minor) lexicographic sort
    seg_s, val_s = jax.lax.sort((seg, norm), dimension=1, num_keys=2)

    # segment q covers positions [pk[q-1], pk[q]) (pk = sorted peak
    # positions, pk[-1] := 0), so valid lengths are pure arithmetic.
    # top_k of the negated positions = the e_cap smallest, ascending —
    # equivalent to lax.sort(...)[:, :e_cap] but lowers to the TopK
    # custom call instead of a full-width bitonic network (the full sort
    # at width 2L was the single biggest compile-time cost of the whole
    # chunk-step program)
    pk_sorted = -jax.lax.top_k(
        -jnp.where(emit_ok, emitted, BIG_I32), e_cap
    )[0]
    qs = jnp.arange(e_cap, dtype=jnp.int32)
    s_q = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), pk_sorted[:, : e_cap - 1]], axis=1)
    e_q = pk_sorted
    lens = jnp.where(
        qs[None, :] < n_ev[:, None],
        jnp.maximum(jnp.minimum(e_q, n_sig[:, None]) - jnp.minimum(s_q, n_sig[:, None]), 0),
        0,
    )
    bound = jnp.cumsum(lens, axis=1)
    starts = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), bound[:, :-1]], axis=1)

    q1_idx = jnp.clip(starts + lens // 4, 0, l - 1)
    q3_idx = jnp.clip(starts + (3 * lens) // 4, 0, l - 1)
    q1 = jnp.take_along_axis(val_s, q1_idx, axis=1)
    q3 = jnp.take_along_axis(val_s, q3_idx, axis=1)
    iqr = q3 - q1
    # packed [B, E+1, 2] bound table -> one gather on the sorted layout
    lohi = jnp.pad(
        jnp.stack([q1 - iqr, q3 + iqr], axis=2), ((0, 0), (0, 1), (0, 0)),
        constant_values=0.0,
    )
    seg_sc = jnp.clip(seg_s, 0, e_cap)
    bnd = jnp.take_along_axis(lohi, seg_sc[:, :, None], axis=1)
    keep_s = (seg_s < e_cap) & (val_s >= bnd[:, :, 0]) & (val_s <= bnd[:, :, 1])

    # segment sums/counts = prefix-sum differences over the sorted row
    psum = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.float32),
         jnp.cumsum(jnp.where(keep_s, val_s, 0.0), axis=1)], axis=1
    )
    pcnt = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32),
         jnp.cumsum(keep_s.astype(jnp.int32), axis=1)], axis=1
    )
    ends = starts + lens
    sums = jnp.take_along_axis(psum, ends, axis=1) - jnp.take_along_axis(
        psum, starts, axis=1
    )
    counts = jnp.take_along_axis(pcnt, ends, axis=1) - jnp.take_along_axis(
        pcnt, starts, axis=1
    )
    events = jnp.where(counts > 0, sums / jnp.maximum(counts, 1), 0.0)
    ev_mask = qs[None, :] < n_ev[:, None]
    return jnp.where(ev_mask, events, 0.0), n_ev


@functools.partial(
    jax.jit,
    static_argnames=(
        "window_length1",
        "window_length2",
        "e_cap",
    ),
)
def detect_events_batch(
    sig: jnp.ndarray,  # f32 [B, L] padded raw signal chunk
    slen: jnp.ndarray,  # i32 [B] valid samples per row
    carry: NormCarry,
    *,
    window_length1: int = 3,
    window_length2: int = 9,
    threshold1: float = 4.0,
    threshold2: float = 3.5,
    peak_height: float = 0.4,
    e_cap: int = 1024,
):
    """Batched equivalent of the reference detect_events (revent.c:257-316).

    Returns (events [B, e_cap], n_events [B], new_carry)."""
    b, l = sig.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1)
    valid = pos < slen[:, None]
    sig_m = jnp.where(valid, sig, 0.0)

    new_sum = carry.sum + jnp.sum(sig_m, axis=1)
    new_sumsq = carry.sum_sq + jnp.sum(sig_m * sig_m, axis=1)
    new_n = carry.n + slen
    nf = jnp.maximum(new_n, 1).astype(jnp.float32)
    mean = new_sum / nf
    std = jnp.sqrt(jnp.maximum(new_sumsq / nf - mean * mean, 0.0))
    std = jnp.where(std > 0, std, 1.0)
    norm = (sig - mean[:, None]) / std[:, None]
    clip = valid & (norm < 3.0) & (norm > -3.0)
    normc, n_sig = dense_compact(norm, clip)

    prefix = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.float32), jnp.cumsum(normc, axis=1)], axis=1
    )
    prefix_sq = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.float32), jnp.cumsum(normc * normc, axis=1)], axis=1
    )
    ts1 = _tstat(prefix, prefix_sq, n_sig, window_length1)
    ts2 = _tstat(prefix, prefix_sq, n_sig, window_length2)

    emitted = _gen_peaks(
        ts1, ts2, n_sig, threshold1, threshold2,
        window_length1, window_length2, peak_height,
    )
    ok = (emitted > 0) & (emitted < n_sig[:, None])
    n_peaks = jnp.sum(ok, axis=1).astype(jnp.int32)

    events, n_ev = _segment_events(normc, n_sig, emitted, ok, n_peaks, e_cap)
    return events, n_ev, NormCarry(new_sum, new_sumsq, new_n)
