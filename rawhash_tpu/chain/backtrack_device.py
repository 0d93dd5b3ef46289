"""Device-side chain backtracking + compaction (batched).

Device re-design of the host tail's first half (reference:
mg_chain_backtrack, lchain.c:95-194 + compact_a, lchain.c:214-281): instead
of shipping EVERY anchor's (f, p) to the host per chunk (O(anchors) D2H),
the sequential greedy backtrack runs on-device as one batched
``lax.while_loop`` state machine — every read advances its own walk one step
per iteration — and only tiny per-chain summaries leave the device.  Carried
chain anchors (the reference's *_a arrays, rmap.cpp:111-116) never leave the
device at all.

Semantics match the host oracle (chain/host.py::chain_backtrack +
compact_chains) exactly, with one representational difference: the
reference's mark(2)-walk-then-reset in mg_chain_bk_end is replaced by a
per-candidate visit stamp (t2 == k), which is equivalent because candidate
indices strictly decrease.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INT32_MIN = -(2**31)
NEG_INF = np.int32(INT32_MIN)  # numpy scalar: inlines as a literal (no const hoisting)


def backtrack_batch(
    f: jnp.ndarray,  # i32 [B, N] chain scores (fill output)
    p: jnp.ndarray,  # i32 [B, N] predecessor indices (-1 = none)
    n_anchors: jnp.ndarray,  # i32 [B]
    *,
    min_cnt: int,
    min_sc: int,
    max_drop: int,
    k_cap: int,
):
    """All-chains backtrack for a batch of reads.

    Returns (u_sc i32 [B,K], u_cnt i32 [B,K], n_u i32 [B],
             v i32 [B,N] claimed anchor indices in discovery order
             (chain-major, each chain end->start), n_v i32 [B],
             chain_overflow i32 [B] — chains dropped because n_u hit K).
    """
    b, n = f.shape
    rows = jnp.arange(b, dtype=jnp.int32)
    slots = jnp.arange(n, dtype=jnp.int32)

    # candidates sorted by (f, idx) ascending — identical order to the
    # host's stable argsort over f>=min_sc anchors (lchain.c:130); padded
    # slots sink to the front with f = INT32_MIN and are never reached
    # (iteration starts at the top and stops at the first f < min_sc)
    f_m = jnp.where(slots[None, :] < n_anchors[:, None], f, NEG_INF)
    z_f, z_idx = jax.lax.sort(
        (f_m, jnp.broadcast_to(slots[None, :], (b, n))),
        dimension=1, num_keys=1, is_stable=True,
    )

    # per-read state arrays ride FLAT [B*N] (or [B*K]) buffers and every
    # per-iteration access is a 1D gather/scatter at rows*width + idx,
    # which keeps the loop state layout explicit.
    def gather(arr, idx):
        if arr.ndim == 2:  # z_f/z_idx/f/p inputs stay 2D (read-only)
            return arr[rows, jnp.clip(idx, 0, arr.shape[1] - 1)]
        w = arr.shape[0] // b
        return arr[rows * w + jnp.clip(idx, 0, w - 1)]

    def scatter_where(arr, idx, val, mask):
        w = arr.shape[0] // b
        fi = rows * w + jnp.clip(idx, 0, w - 1)
        cur = arr[fi]
        return arr.at[fi].set(jnp.where(mask, val, cur))

    # state machine phases: 0 select candidate, 1 bk_end walk, 2 claim walk,
    # 3 done
    def cond(state):
        phase = state[0]
        return jnp.any(phase != 3)

    def step(state):
        (phase, k, i, end_i, max_i, max_s, zsc, n_v, n_v0, n_u,
         t1, t2, v, u_sc, u_cnt, ovf) = state

        # ---- phase 0: pick the next unused candidate (lchain.c:131-137)
        in0 = phase == 0
        # vectorized used-candidate skip: at 100k+ anchor widths most
        # candidates are already claimed by an earlier chain, and burning
        # one lockstep iteration per skip dominated the whole backtrack
        # (~15 s/chunk at 147k).  Probe SKIP_W candidates at once and jump
        # past the leading run of used ones — identical to the sequential
        # one-by-one skip because only candidates that WOULD have been
        # skipped (valid and t1 != 0) are counted, stopping at the first
        # non-skippable.
        lead = jnp.zeros(b, jnp.int32)
        still = in0
        for d in range(8):
            kd = k - d
            kf_d = gather(z_f, kd)
            ki_d = gather(z_idx, kd)
            skip_d = (
                (kd >= 0) & (kf_d >= min_sc) & (gather(t1, ki_d) != 0)
            )
            still = still & skip_d
            lead = lead + still.astype(jnp.int32)
        k = jnp.where(in0, k - lead, k)
        k_idx = gather(z_idx, k)
        k_f = gather(z_f, k)
        exhausted = in0 & ((k < 0) | (k_f < min_sc))
        used = in0 & ~exhausted & (gather(t1, k_idx) != 0)
        start = in0 & ~exhausted & ~used
        # enter walk A (mg_chain_bk_end init, lchain.c:49-56)
        phase = jnp.where(exhausted, 3, phase)
        k = jnp.where(used, k - 1, k)
        i = jnp.where(start, k_idx, i)
        max_i = jnp.where(start, k_idx, max_i)
        max_s = jnp.where(start, 0, max_s)
        zsc = jnp.where(start, k_f, zsc)
        n_v0 = jnp.where(start, n_v, n_v0)
        phase = jnp.where(start, 1, phase)

        # ---- phase 1: one bk_end step (lchain.c:57-70)
        in1 = phase == 1
        t2 = scatter_where(t2, i, k, in1)  # t[i] = 2 -> stamp with k
        ni = gather(p, i)
        s = jnp.where(ni < 0, zsc, zsc - gather(f, ni))
        better = s > max_s
        brk = ~better & (max_s - s > max_drop)
        max_s1 = jnp.where(in1 & better, s, max_s)
        max_i1 = jnp.where(in1 & better, ni, max_i)
        cont = (
            ~brk & (ni >= 0) & (gather(t1, ni) == 0) & (gather(t2, ni) != k)
        )
        # walk A finished: end at max_i, restart from the candidate head
        finishA = in1 & ~cont
        end_i = jnp.where(finishA, max_i1, end_i)
        max_s = jnp.where(in1, max_s1, max_s)
        max_i = jnp.where(in1, max_i1, max_i)
        i = jnp.where(in1, jnp.where(cont, ni, k_idx), i)
        phase = jnp.where(finishA, 2, phase)

        # ---- phase 2: one claim step (lchain.c:139-146)
        in2 = phase == 2
        claiming = in2 & (i != end_i)
        v = scatter_where(v, n_v, i, claiming)
        t1 = scatter_where(t1, i, 1, claiming)
        n_v = jnp.where(claiming, n_v + 1, n_v)
        i2 = gather(p, i)
        finished = in2 & ~claiming
        # chain accept/reject (lchain.c:147-158)
        sc = jnp.where(i < 0, zsc, zsc - gather(f, i))
        cnt = n_v - n_v0
        accept = finished & (sc >= min_sc) & (cnt > 0) & (cnt >= min_cnt)
        fits = n_u < k_cap
        u_sc = scatter_where(u_sc, n_u, sc, accept & fits)
        u_cnt = scatter_where(u_cnt, n_u, cnt, accept & fits)
        ovf = jnp.where(accept & ~fits, ovf + 1, ovf)
        n_u = jnp.where(accept & fits, n_u + 1, n_u)
        # rejected chains (and overflowed ones) release their claim slots
        n_v = jnp.where(finished & ~(accept & fits), n_v0, n_v)
        i = jnp.where(in2, jnp.where(claiming, i2, i), i)
        k = jnp.where(finished, k - 1, k)
        phase = jnp.where(finished, 0, phase)

        return (phase, k, i, end_i, max_i, max_s, zsc, n_v, n_v0, n_u,
                t1, t2, v, u_sc, u_cnt, ovf)

    zero = jnp.zeros(b, jnp.int32)
    state = (
        zero,  # phase
        jnp.full(b, n - 1, jnp.int32),  # k
        zero, jnp.full(b, -1, jnp.int32),  # i, end_i
        zero, zero, zero,  # max_i, max_s, zsc
        zero, zero, zero,  # n_v, n_v0, n_u
        jnp.zeros(b * n, jnp.int32),  # t1 used marks (flat)
        jnp.full(b * n, -1, jnp.int32),  # t2 visit stamps (flat)
        jnp.zeros(b * n, jnp.int32),  # v (flat)
        jnp.zeros(b * k_cap, jnp.int32),  # u_sc (flat)
        jnp.zeros(b * k_cap, jnp.int32),  # u_cnt (flat)
        zero,  # chain overflow count
    )
    state = jax.lax.while_loop(cond, step, state)
    (_, _, _, _, _, _, _, n_v, _, n_u, _, _, v, u_sc, u_cnt, ovf) = state
    return (
        u_sc.reshape(b, k_cap), u_cnt.reshape(b, k_cap), n_u,
        v.reshape(b, n), n_v, ovf,
    )


def compact_batch(
    u_sc, u_cnt, n_u, v, n_v,
    s_key, s_tpos, s_qpos,  # sorted anchor planes [B, N]
    *,
    q_span: int,
):
    """Vectorized compact_a (lchain.c:214-281) over the batch.

    Returns:
      asc       i32 [B, N]  anchor indices, chain-major (discovery order),
                            each chain's anchors ASCENDING — the carried
                            anchor order (the reference's *_a)
      order     i32 [B, K]  chains sorted by first-anchor x (stable)
      summaries i32 [B, K, 10] in sorted-chain order:
        [score, cnt, key(u32 bits), tpos0, qpos0, tposL, qposL, mlen, blen,
         valid]
    """
    b, n = v.shape
    k_cap = u_sc.shape[1]
    rows = jnp.arange(b, dtype=jnp.int32)
    slots = jnp.arange(n, dtype=jnp.int32)
    cids = jnp.arange(k_cap, dtype=jnp.int32)

    chain_valid = cids[None, :] < n_u[:, None]
    cnts = jnp.where(chain_valid, u_cnt, 0)
    ends = jnp.cumsum(cnts, axis=1)
    starts = ends - cnts

    # chain id per claimed slot: scatter chain ids at their start slots and
    # forward-fill (same trick as index/device.py::expand_hits)
    tgt = jnp.where(chain_valid & (cnts > 0), starts, n)
    marker = (
        jnp.zeros((b, n + 1), jnp.int32)
        .at[rows[:, None], tgt]
        .max(jnp.broadcast_to(cids[None, :], (b, k_cap)))[:, :n]
    )
    cid = jax.lax.cummax(marker, axis=1)  # [B, N]
    valid_slot = slots[None, :] < n_v[:, None]

    # v holds each chain end->start; ascending index within the chain is the
    # mirrored gather v[starts[c] + ends[c] - 1 - m]
    st_m = jnp.take_along_axis(starts, cid, axis=1)
    en_m = jnp.take_along_axis(ends, cid, axis=1)
    g = jnp.clip(st_m + en_m - 1 - slots[None, :], 0, n - 1)
    asc = jnp.take_along_axis(v, g, axis=1)
    asc = jnp.where(valid_slot, asc, 0)

    # anchor planes in chain-major ascending order
    a_key = jnp.take_along_axis(s_key, asc, axis=1)
    a_tpos = jnp.take_along_axis(s_tpos, asc, axis=1)
    a_qpos = jnp.take_along_axis(s_qpos, asc, axis=1)

    # fuzzy match lengths (mm_cal_fuzzy_len, hit.c:10-40): pairwise deltas
    # within chains, segment-summed via masked cumsum
    tl = a_tpos - jnp.concatenate([a_tpos[:, :1], a_tpos[:, :-1]], axis=1)
    ql = a_qpos - jnp.concatenate([a_qpos[:, :1], a_qpos[:, :-1]], axis=1)
    is_first = slots[None, :] == st_m
    mx = jnp.maximum(tl, ql)
    mn = jnp.minimum(tl, ql)
    ml = jnp.where((tl > q_span) & (ql > q_span), q_span, mn) + mn
    mx = jnp.where(is_first | ~valid_slot, 0, mx)
    ml = jnp.where(is_first | ~valid_slot, 0, ml)
    cb = jnp.cumsum(mx, axis=1)
    cm = jnp.cumsum(ml, axis=1)

    def seg(c, arr):
        lo = jnp.take_along_axis(arr, jnp.clip(starts, 0, n - 1), axis=1)
        hi = jnp.take_along_axis(arr, jnp.clip(ends - 1, 0, n - 1), axis=1)
        return hi - lo

    blen = jnp.where(chain_valid & (cnts > 0), q_span + seg(cids, cb), 0)
    mlen = jnp.where(chain_valid & (cnts > 0), q_span + seg(cids, cm), 0)

    def at_start(arr):
        return jnp.take_along_axis(arr, jnp.clip(starts, 0, n - 1), axis=1)

    def at_end(arr):
        return jnp.take_along_axis(arr, jnp.clip(ends - 1, 0, n - 1), axis=1)

    key0 = at_start(a_key)
    tpos0, qpos0 = at_start(a_tpos), at_start(a_qpos)
    tposL, qposL = at_end(a_tpos), at_end(a_qpos)

    # chain sort by first-anchor x = rev<<63|tid<<32|tpos via two 32-bit
    # keys (stable, invalid chains sink to the end) — compact_a's radix
    # sort (lchain.c:260).  key0's bit layout (rev<<31|tid) orders exactly
    # like the x word's high half.
    live = chain_valid & (cnts > 0)
    sk1 = jnp.where(live, key0, jnp.uint32(0xFFFFFFFF))
    sk2 = jnp.where(live, tpos0, jnp.int32(0x7FFFFFFF))
    (_, _, order) = jax.lax.sort(
        (sk1, sk2, jnp.broadcast_to(cids[None, :], (b, k_cap))),
        dimension=1, num_keys=2, is_stable=True,
    )

    def pick(arr):
        return jnp.take_along_axis(arr, order, axis=1)

    summaries = jnp.stack(
        [
            pick(jnp.where(chain_valid, u_sc, 0)),
            pick(cnts),
            pick(jax.lax.bitcast_convert_type(key0, jnp.int32)),
            pick(tpos0), pick(qpos0), pick(tposL), pick(qposL),
            pick(mlen), pick(blen),
            pick((chain_valid & (cnts > 0)).astype(jnp.int32)),
        ],
        axis=2,
    )
    return asc, order, summaries


@functools.partial(
    jax.jit,
    static_argnames=("min_cnt", "min_sc", "max_drop", "k_cap", "q_span"),
)
def backtrack_compact(
    f, p, n_anchors, s_key, s_tpos, s_qpos,
    *, min_cnt: int, min_sc: int, max_drop: int, k_cap: int, q_span: int,
):
    """backtrack + compact in one program (the standalone entry; the fused
    chunk step calls the two pieces directly)."""
    u_sc, u_cnt, n_u, v, n_v, ovf = backtrack_batch(
        f, p, n_anchors,
        min_cnt=min_cnt, min_sc=min_sc, max_drop=max_drop, k_cap=k_cap,
    )
    asc, order, summaries = compact_batch(
        u_sc, u_cnt, n_u, v, n_v, s_key, s_tpos, s_qpos, q_span=q_span
    )
    return summaries, n_u, asc, n_v, ovf
