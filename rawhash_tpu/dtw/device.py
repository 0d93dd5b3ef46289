"""Batched slanted-band DTW on device (JAX).

The reference's antidiagonal-wavefront slanted-band DTW (dtw.cpp:273-520) is
already shaped for SIMD; here the same recurrence advances one column of the
band per lax.scan step, with the band living in vector lanes and many
alignment problems batched in the leading axis — the device layout for
the sparse (anchor-to-anchor) chain evaluation where thousands of small
alignments run at once.

Each problem carries its own runtime band radius (the reference sizes the
band as a fraction of the query length per segment, rmap.cpp:155,189); the
kernel's static width is the batch maximum, and narrower rows simply mask
the outer lanes to BIG.

The top-coupling inside a column (new[o] depends on new[o-1]) is solved with
the prefix-min identity used by dtw/banded.py:
    new[o] = min_{k<=o}(best[k] + cost[k] - csum[k]) + csum[o]
which is an associative cummin — vectorizable across the band.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(1e10)  # numpy scalar: inlines as a literal (no const hoisting)


@functools.partial(jax.jit, static_argnames=("max_radius", "max_len"))
def dtw_banded_batch(
    a: jnp.ndarray,  # f32 [B, max_len]  (the longer sequence per pair)
    a_len: jnp.ndarray,  # i32 [B]
    b: jnp.ndarray,  # f32 [B, max_len]
    b_len: jnp.ndarray,  # i32 [B]
    radius: jnp.ndarray,  # i32 [B]  per-pair band radius (<= max_radius)
    *,
    max_radius: int,
    max_len: int,
):
    """Banded DTW cost for B padded sequence pairs.

    Callers must place the longer sequence of each pair in `a` (the host
    wrapper below handles the swap).  Returns f32 [B] total |a-b| warping
    cost with global borders."""
    bsz = a.shape[0]
    r = max_radius
    width = 2 * r + 1
    offs = jnp.arange(-r, r + 1, dtype=jnp.int32)
    radius = jnp.minimum(radius.astype(jnp.int32), r)

    # first column: cumulative cost down rows 0..min(radius, blen-1)
    j0 = jnp.arange(width, dtype=jnp.int32) - r
    ok0 = (
        (j0[None, :] >= 0)
        & (j0[None, :] < b_len[:, None])
        & (j0[None, :] <= radius[:, None])
    )
    col0 = jnp.where(
        ok0,
        jnp.abs(a[:, :1] - jnp.take_along_axis(
            b, jnp.clip(j0, 0, max_len - 1)[None, :].repeat(bsz, 0), axis=1
        )),
        BIG,
    )
    # cumulative sum along the valid prefix (invalid slots saturate at BIG)
    init_dp = jnp.where(
        j0[None, :] >= 0,
        jnp.cumsum(jnp.where(j0[None, :] >= 0, jnp.minimum(col0, BIG), 0.0), axis=1),
        BIG,
    )
    init_dp = jnp.where(col0 >= BIG, BIG, init_dp)

    def step(carry, i):
        dp, center = carry
        alive = i < a_len
        nxt = center + 1
        inc = (nxt * a_len) <= (b_len * i)
        center2 = jnp.where(inc & alive, nxt, center)
        j = center2[:, None] + offs[None, :]
        valid = (
            (j >= 0)
            & (j < b_len[:, None])
            & (jnp.abs(offs)[None, :] <= radius[:, None])
        )
        a_i = jnp.take_along_axis(a, jnp.clip(i, 0, max_len - 1)[None, None].repeat(bsz, 0)[:, 0][:, None], axis=1)
        cost = jnp.abs(
            a_i - jnp.take_along_axis(b, jnp.clip(j, 0, max_len - 1), axis=1)
        )
        shifted = jnp.concatenate([dp[:, 1:], jnp.full((bsz, 1), BIG)], axis=1)
        up1 = jnp.concatenate([jnp.full((bsz, 1), BIG), dp[:, :-1]], axis=1)
        left = jnp.where(inc[:, None], shifted, dp)
        topleft = jnp.where(inc[:, None], dp, up1)
        # reference guard: after a slide, the slot whose target row is j==0
        # has no (i-1, j-1) predecessor (only real when center + off > 0)
        edge_slot = jnp.clip(r - center2, 0, width - 1)
        tl_fix = (center2 - radius) <= 0
        topleft = jnp.where(
            inc[:, None]
            & tl_fix[:, None]
            & (jnp.arange(width)[None, :] == edge_slot[:, None]),
            BIG,
            topleft,
        )
        best = jnp.minimum(left, topleft)
        bm = jnp.minimum(best + cost, BIG)
        csum = jnp.cumsum(cost, axis=1)
        new = jnp.minimum.accumulate(bm - csum, axis=1) + csum
        new = jnp.where(valid, jnp.minimum(new, BIG), BIG)
        dp2 = jnp.where(alive[:, None], new, dp)
        return (dp2, center2), None

    (dp, center), _ = jax.lax.scan(
        step, (init_dp, jnp.zeros(bsz, jnp.int32)),
        jnp.arange(1, max_len, dtype=jnp.int32),
    )
    out_slot = jnp.clip(b_len - 1 - center + r, 0, width - 1)
    return jnp.take_along_axis(dp, out_slot[:, None], axis=1)[:, 0]


def _pow2_at_least(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def dtw_banded_batch_host(pairs, band_radius):
    """Host wrapper: [(a, b)] float32 pairs -> costs [len(pairs)].

    `band_radius` is an int applied to every pair or a per-pair sequence.
    Handles the longer-sequence swap and padding, then runs one device
    program for the whole batch.  Pad sizes are bucketed to powers of two so
    the jitted kernel compiles only O(log^2) variants."""
    if not pairs:
        return np.zeros(0, dtype=np.float32)
    bsz = len(pairs)
    if np.isscalar(band_radius):
        radii = np.full(bsz, int(band_radius), dtype=np.int32)
    else:
        radii = np.asarray(band_radius, dtype=np.int32)
    swapped = []
    for x, y in pairs:
        if x.shape[0] < y.shape[0]:
            x, y = y, x
        swapped.append((x, y))
    max_len = _pow2_at_least(max(x.shape[0] for x, _ in swapped), 16)
    max_radius = _pow2_at_least(int(radii.max()), 4)
    a = np.zeros((bsz, max_len), dtype=np.float32)
    b = np.zeros((bsz, max_len), dtype=np.float32)
    a_len = np.zeros(bsz, dtype=np.int32)
    b_len = np.zeros(bsz, dtype=np.int32)
    for i, (x, y) in enumerate(swapped):
        a[i, : x.shape[0]] = x
        b[i, : y.shape[0]] = y
        a_len[i] = x.shape[0]
        b_len[i] = y.shape[0]
    out = dtw_banded_batch(
        jnp.asarray(a), jnp.asarray(a_len), jnp.asarray(b), jnp.asarray(b_len),
        jnp.asarray(radii), max_radius=max_radius, max_len=max_len,
    )
    return np.asarray(out)
