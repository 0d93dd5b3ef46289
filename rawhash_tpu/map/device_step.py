"""The fused per-chunk device step: raw signal -> chained anchor scores.

One jitted XLA program per chunk batch runs the whole device-side pipeline
(reference equivalent: the body of ri_map_frag, rmap.cpp:210-387):

    detect events -> sketch -> index lookup -> occurrence filter + rep_len ->
    CSR hit expansion -> (all-vs-all name-rank filter) -> merge carried
    anchors -> lexicographic sort -> chaining DP fill

Host code (map/engine.py) then backtracks chains and makes mapping decisions
on the tiny per-read outputs.  All shapes are static; per-read validity runs
in masks and counts.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..chain.device import chain_fill_batch
from ..chain.pallas_fill import chain_fill_pallas
from ..index.device import DeviceIndex, expand_hits, lookup_counts
from ..signal.events import NormCarry, dense_compact, detect_events_batch
from ..sketch.device import sketch_batch

import numpy as np

# numpy scalar, NOT a jnp array: module-level device-array constants get
# hoisted into the jaxpr as constant *parameters*, and the jax 0.9.0 C++
# jit fastpath fails to supply hoisted constants on repeat calls after a
# signature change ("Executable expected parameter 0 of size 4")
U32_MAX = np.uint32(0xFFFFFFFF)


class CompileLog:
    """Process-wide ledger of first-call program builds (compile or
    persistent-cache load): (fn_name, seconds, n_signature).  The bench uses
    it to split warmup into program builds and everything else."""

    entries: list = []

    @classmethod
    def total_s(cls) -> float:
        return sum(e[1] for e in cls.entries)


class AotMemo:
    """Own (signature -> dedicated jit object) memo around a jitted function.

    Works around a jax 0.9.0 C++ jit-fastpath cache collision: after a
    signature change on ONE jit object (e.g. the engine's capacity growth
    recompiles with a wider carried-anchor buffer), the SECOND call of the
    new signature retrieves the old signature's executable and dies with
    "Executable expected parameter N of size ...".  Giving every
    (shape, statics) signature its own jax.jit instance keeps each fastpath
    cache single-entry, which is the collision-free case; compiles still hit
    the persistent compilation cache."""

    def __init__(self, jitfn):
        self.raw = jitfn.__wrapped__
        self.cache = {}
        # abstract arguments of each signature, for lowering it again
        # (memory analysis) without the live buffers
        self.specs = {}
        import threading

        self._lock = threading.Lock()

    def __call__(self, *args, **statics):
        key = (
            tuple(
                (tuple(a.shape), str(a.dtype))
                for a in jax.tree_util.tree_leaves(args)
            ),
            tuple(sorted(statics.items())),
        )
        with self._lock:
            jf = self.cache.get(key)
            new = jf is None
            if new:
                jf = jax.jit(
                    functools.partial(self.raw, **statics), keep_unused=True
                )
                self.cache[key] = jf
                self.specs[key] = jax.tree_util.tree_map(
                    lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), args
                )
        if not new:
            return jf(*args)
        import sys
        import time as _time

        t0 = _time.perf_counter()
        out = jf(*args)
        CompileLog.entries.append(
            (self.raw.__name__, _time.perf_counter() - t0, len(self.cache))
        )
        if os.environ.get("RAWHASH_TPU_LOG_COMPILES"):
            jax.block_until_ready(out)
            shapes = [tuple(a.shape) for a in jax.tree_util.tree_leaves(args)]
            print(
                f"[rawhash-tpu compile] {self.raw.__name__} sig#{len(self.cache)}"
                f" {_time.perf_counter() - t0:.1f}s shapes={shapes}"
                f" statics={dict(sorted(statics.items()))}",
                file=sys.stderr,
            )
        return out


class ChunkOut(NamedTuple):
    # every per-anchor output rides ONE int16 buffer so the host pays a
    # single D2H transfer per chunk instead of one per array.  Word layout
    # along the last axis
    # (qpos/f/p fit int16: event offsets < 2^15, chain scores < 2^15 for
    # real spans, predecessor indices < N <= 2^15):
    #   words[0:key_words]  (rev, tid, tpos) packed little-endian —
    #     key_words is chosen per index so small genomes pay 1 word instead
    #     of 4 (key_words=4 keeps the full split: key_lo, key_hi, tpos_lo,
    #     tpos_hi)
    #   then: qpos, f, p
    packed: jnp.ndarray  # i16 [B, N, key_words+3] sorted anchors
    # per-read scalar block, one small transfer:
    #   0 n_anchors, 1 rep_len, 2 n_events, 3 processed, 4 hit_overflow,
    #   5 ev_offset, 6 pack_overflow (anchors dropped from packed_flat
    #   because total > flat_cap; replicated on every row; 0 dense mode)
    scalars: jnp.ndarray  # i32 [B, 7]
    events: jnp.ndarray  # f16 [B, E] this chunk's events (for DTW)
    carry: NormCarry
    ev_offset: jnp.ndarray  # i32 [B] updated event offset (device-resident)
    # sharded engine only: per-device locally-owned seed-hit totals
    # (i32 [n_devices]) for work-balance observability; None single-device
    shard_hits: jnp.ndarray | None = None
    # flat exact-count packed anchors ([flat_cap, words], rows packed
    # back-to-back at cumsum(n_anchors) offsets) when the step ran with
    # flat_cap > 0; `packed` is a placeholder then.  The host-tail fetch
    # moves O(total anchors) bytes instead of B x pow2(max row width)
    packed_flat: jnp.ndarray | None = None


def decode_prev_pack(prev_pack: jnp.ndarray):
    """Split the packed H2D upload into carried-anchor planes + slen."""
    p_cap = (prev_pack.shape[1] - 2) // 3
    prev_key = jax.lax.bitcast_convert_type(prev_pack[:, :p_cap], jnp.uint32)
    prev_tpos = prev_pack[:, p_cap : 2 * p_cap]
    prev_qpos = prev_pack[:, 2 * p_cap : 3 * p_cap]
    n_prev = prev_pack[:, 3 * p_cap]
    slen = prev_pack[:, 3 * p_cap + 1]
    return prev_key, prev_tpos, prev_qpos, n_prev, slen


def events_and_sketch(
    sig, slen, carry, *,
    window_length1, window_length2, threshold1, threshold2, peak_height,
    e_cap, min_events,
    diff, w, e, q, k, fine_min, fine_max, fine_range,
):
    """Stages shared by the single-device and sharded chunk steps:
    event detection (revent.c:257) + sketching (rsketch.c:271)."""
    events, n_ev, carry2 = detect_events_batch(
        sig, slen, carry,
        window_length1=window_length1, window_length2=window_length2,
        threshold1=threshold1, threshold2=threshold2, peak_height=peak_height,
        e_cap=e_cap,
    )
    processed = n_ev >= min_events  # reference: rmap.cpp:232
    hashes, qpos_seed, seed_valid = sketch_batch(
        events, n_ev,
        diff=diff, w=w, e=e, q=q, k=k,
        fine_min=fine_min, fine_max=fine_max, fine_range=fine_range,
    )
    seed_valid = seed_valid & processed[:, None]
    return events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid


def rep_len_from_filtered(qpos_seed, flt, span):
    """Union length of the q-intervals of occurrence-filtered seeds
    (reference: rseed.c:134-151)."""
    b = qpos_seed.shape[0]
    st_i = qpos_seed + 1
    en_i = st_i + span + 1
    en_m = jnp.where(flt, en_i, 0)
    cummax_en = jax.lax.cummax(en_m, axis=1)
    excl = jnp.concatenate(
        [jnp.zeros((b, 1), en_m.dtype), cummax_en[:, :-1]], axis=1
    )
    contrib = jnp.maximum(en_i - jnp.maximum(st_i, excl), 0)
    return jnp.sum(jnp.where(flt, contrib, 0), axis=1).astype(jnp.int32)


def select_fill(platform: str):
    """The chain fill for a JAX platform: the Pallas kernel (Triton route)
    on the GPU, the lax.scan oracle on the CPU.  Both give bit-identical
    (f, p)."""
    fills = {"gpu": chain_fill_pallas, "cpu": chain_fill_batch}
    if platform not in fills:
        raise ValueError(
            f"no chain fill for platform {platform!r}; supported: gpu, cpu"
        )
    return fills[platform]


def merge_sort_fill(
    a_key, a_tpos, a_qpos, slot_valid, n_hits,
    prev_key, prev_tpos, prev_qpos, n_prev,
    q_rank, target_rank,
    *,
    span: int, max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    all_vs_all: bool,
    fill=None,
):
    """Shared middle of both chunk steps: all-vs-all filter -> carried-anchor
    merge -> lexicographic sort -> chaining DP fill (reference:
    rmap.cpp:86-121 + mg_lchain_dp, lchain.c:385).
    Returns (s_key, s_tpos, s_qpos, n_anchors, f, p)."""
    b, a_cap = a_key.shape
    p_cap = prev_key.shape[1]
    keep = slot_valid
    if all_vs_all:
        # skip targets whose name sorts <= the query's name
        # (reference: rmap.cpp:86 strcmp(qname, ref_name) >= 0 -> skip)
        hit_id = (a_key & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        tr = target_rank[jnp.clip(hit_id, 0, target_rank.shape[0] - 1)]
        keep = keep & (tr > q_rank[:, None])
        a_key, n_new = dense_compact(a_key, keep)
        a_tpos, _ = dense_compact(a_tpos, keep)
        a_qpos, _ = dense_compact(a_qpos, keep)
    else:
        n_new = n_hits.astype(jnp.int32)

    # --- merge carried anchors, sort (reference: rmap.cpp:111-121) ---
    pidx = jnp.arange(p_cap, dtype=jnp.int32)
    prev_valid = pidx[None, :] < n_prev[:, None]
    slots_new = jnp.arange(a_cap, dtype=jnp.int32)
    new_valid = slots_new[None, :] < n_new[:, None]

    m_key = jnp.concatenate(
        [jnp.where(new_valid, a_key, U32_MAX), jnp.where(prev_valid, prev_key, U32_MAX)],
        axis=1,
    )
    m_tpos = jnp.concatenate(
        [jnp.where(new_valid, a_tpos, jnp.int32(0x7FFFFFFF)),
         jnp.where(prev_valid, prev_tpos, jnp.int32(0x7FFFFFFF))],
        axis=1,
    )
    m_qpos = jnp.concatenate([a_qpos, prev_qpos], axis=1).astype(jnp.int32)
    n_anchors = n_new + n_prev

    s_key, s_tpos, s_qpos = jax.lax.sort(
        (m_key, m_tpos, m_qpos), dimension=1, num_keys=2, is_stable=True
    )

    # --- chaining DP fill (reference: mg_lchain_dp, lchain.c:385) ---
    if fill is None:
        fill = select_fill(jax.default_backend())
    f, p = fill(
        s_key, s_tpos, s_qpos, n_anchors,
        q_span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
    )
    return s_key, s_tpos, s_qpos, n_anchors, f, p


def finish_chunk(
    a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
    rep_len, events, n_ev, processed, carry2, ev_offset2,
    prev_key, prev_tpos, prev_qpos, n_prev,
    q_rank, target_rank,
    *,
    span: int, max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    all_vs_all: bool, keep_events: bool,
    key_words: int, pos_bits: int,
    wide: bool = False,
    flat_cap: int = 0,
) -> "ChunkOut":
    """Back half of the chunk step, shared by the single-device and sharded
    paths: all-vs-all filter -> carried-anchor merge -> sort -> chain fill ->
    i16 packing (reference: rmap.cpp:86-121 + mg_lchain_dp, lchain.c:385)."""
    b = a_key.shape[0]
    s_key, s_tpos, s_qpos, n_anchors, f, p = merge_sort_fill(
        a_key, a_tpos, a_qpos, slot_valid, n_hits,
        prev_key, prev_tpos, prev_qpos, n_prev,
        q_rank, target_rank,
        span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
        all_vs_all=all_vs_all,
    )

    n_total = s_key.shape[1]
    if wide:
        # i32 packing for large anchor capacities (n_total >= 2^15) or
        # genome-scale qpos/score ranges: 5 words [key, tpos, qpos, f, p].
        # Twice the bytes of the narrow layout, used only when the engine's
        # capacity growth crosses the int16 range (reference never
        # truncates hits: rh_kvec growth, rseed.c:105-154)
        packed = jnp.concatenate(
            [
                jax.lax.bitcast_convert_type(s_key, jnp.int32)[:, :, None],
                s_tpos[:, :, None],
                s_qpos[:, :, None],
                f[:, :, None],
                p[:, :, None],
            ],
            axis=2,
        )
        scalars = jnp.stack(
            [
                n_anchors, rep_len, n_ev,
                processed.astype(jnp.int32), overflow.astype(jnp.int32),
                ev_offset2,
            ],
            axis=1,
        ).astype(jnp.int32)
        return ChunkOut(
            packed=packed, scalars=scalars,
            events=events.astype(jnp.float16) if keep_events
            else jnp.zeros((b, 1), jnp.float16),
            carry=carry2,
            ev_offset=ev_offset2,
        )
    assert n_total < (1 << 15), "anchor capacity must fit int16 packing"
    if key_words <= 2:
        # (rev, tid, tpos) fit `key_words` i16 words:
        #   combined = rev << (16*key_words - 1) | tid << pos_bits | tpos
        rev_b = s_key >> jnp.uint32(31)
        tid_b = s_key & jnp.uint32(0x7FFFFFFF)
        combined = (
            (rev_b << jnp.uint32(16 * key_words - 1))
            | (tid_b << jnp.uint32(pos_bits))
            | s_tpos.astype(jnp.uint32)
        )
        key_part = jax.lax.bitcast_convert_type(combined, jnp.int16)[
            :, :, :key_words
        ]
    else:
        key_part = jnp.concatenate(
            [
                jax.lax.bitcast_convert_type(s_key, jnp.int16),  # lo,hi
                jax.lax.bitcast_convert_type(s_tpos, jnp.int16),
            ],
            axis=2,
        )
    packed = jnp.concatenate(
        [
            key_part,
            jnp.clip(s_qpos, -32768, 32767).astype(jnp.int16)[:, :, None],
            jnp.clip(f, -32768, 32767).astype(jnp.int16)[:, :, None],
            p.astype(jnp.int16)[:, :, None],
        ],
        axis=2,
    )
    packed_flat = None
    pack_ovf = jnp.zeros_like(n_anchors)
    if flat_cap:
        # exact-count packing: rows back-to-back at cumsum(n_anchors)
        # offsets; out-of-bounds (overflow) rows drop and are counted so
        # the engine can regrow flat_cap and re-dispatch
        wwords = packed.shape[2]
        offs = jnp.cumsum(n_anchors) - n_anchors
        slot = jnp.arange(packed.shape[1], dtype=jnp.int32)[None, :]
        live = slot < n_anchors[:, None]
        gpos = jnp.where(live, offs[:, None] + slot, flat_cap)
        packed_flat = (
            jnp.zeros((flat_cap, wwords), packed.dtype)
            .at[gpos.reshape(-1)]
            .set(packed.reshape(-1, wwords), mode="drop")
        )
        pack_ovf = jnp.broadcast_to(
            jnp.maximum(jnp.sum(n_anchors) - flat_cap, 0), n_anchors.shape
        )
        packed = jnp.zeros((b, 1, wwords), packed.dtype)
    scalars = jnp.stack(
        [
            n_anchors, rep_len, n_ev,
            processed.astype(jnp.int32), overflow.astype(jnp.int32),
            ev_offset2, pack_ovf,
        ],
        axis=1,
    ).astype(jnp.int32)
    return ChunkOut(
        packed=packed, scalars=scalars,
        events=events.astype(jnp.float16) if keep_events
        else jnp.zeros((b, 1), jnp.float16),
        carry=carry2,
        ev_offset=ev_offset2,
        packed_flat=packed_flat,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "diff", "w", "e", "q", "k",
        "fine_min", "fine_max", "fine_range",
        "window_length1", "window_length2",
        "threshold1", "threshold2", "peak_height",
        "e_cap", "a_cap",
        "min_events", "mid_occ",
        "max_dist_t", "max_dist_q", "bw", "max_iter",
        "chn_pen_gap", "chn_pen_skip",
        "all_vs_all", "keep_events",
        "key_words", "pos_bits", "wide", "flat_cap",
    ),
)
def chunk_step(
    didx: DeviceIndex,
    sig: jnp.ndarray,  # f16/f32 [B, L]
    carry: NormCarry,
    ev_offset: jnp.ndarray,  # i32 [B]
    # ONE packed host upload per chunk (one H2D transfer instead of four):
    # cols [0:P) carried anchor keys (u32 bits), [P:2P) tpos,
    # [2P:3P) qpos, [3P] n_prev, [3P+1] slen
    prev_pack: jnp.ndarray,  # i32 [B, 3P+2]
    q_rank: jnp.ndarray,  # i32 [B] query name rank (ava; device-resident)
    target_rank: jnp.ndarray,  # i32 [n_seq] target name ranks (ava only)
    *,
    # sketch/index params (from the index build)
    diff: float, w: int, e: int, q: int, k: int,
    fine_min: float, fine_max: float, fine_range: float,
    # event detector params
    window_length1: int, window_length2: int,
    threshold1: float, threshold2: float, peak_height: float,
    # capacities
    e_cap: int, a_cap: int,
    # mapping params
    min_events: int, mid_occ: int,
    max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    all_vs_all: bool,
    keep_events: bool = False,
    # D2H anchor packing: (rev, tid, tpos) occupy `key_words` i16 words;
    # pos_bits = bits for tpos inside the combined value (key_words <= 2);
    # wide switches to the 5-word i32 layout (capacities >= 2^15)
    key_words: int = 4, pos_bits: int = 0, wide: bool = False,
    flat_cap: int = 0,
) -> ChunkOut:
    span = k + e - 1
    sig = sig.astype(jnp.float32)  # accept f16 transfer payloads
    prev_key, prev_tpos, prev_qpos, n_prev, slen = decode_prev_pack(prev_pack)

    # --- events + sketch (reference: revent.c:257, rsketch.c:271) ---
    events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid = (
        events_and_sketch(
            sig, slen, carry,
            window_length1=window_length1, window_length2=window_length2,
            threshold1=threshold1, threshold2=threshold2,
            peak_height=peak_height, e_cap=e_cap, min_events=min_events,
            diff=diff, w=w, e=e, q=q, k=k,
            fine_min=fine_min, fine_max=fine_max, fine_range=fine_range,
        )
    )
    ev_offset2 = ev_offset + jnp.where(processed, n_ev, 0)

    # --- seed lookup + occurrence filter (reference: ri_collect_matches) ---
    start, count = lookup_counts(didx, hashes, seed_valid)
    flt = count > mid_occ
    rep_len = rep_len_from_filtered(qpos_seed, flt, span)
    count = jnp.where(flt, 0, count)

    # --- expansion to anchors (reference: collect_seed_hits, rmap.cpp:51) ---
    seed_c, hit_id, hit_ps, slot_valid, n_hits, overflow = expand_hits(
        didx, start, count, a_cap
    )
    a_qpos = jnp.take_along_axis(qpos_seed, seed_c, axis=1) + ev_offset[:, None]
    a_key = ((hit_ps & 1) << 31) | hit_id
    a_tpos = ((hit_ps >> 1) & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)

    return finish_chunk(
        a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
        rep_len, events, n_ev, processed, carry2, ev_offset2,
        prev_key, prev_tpos, prev_qpos, n_prev,
        q_rank, target_rank,
        span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
        all_vs_all=all_vs_all, keep_events=keep_events,
        key_words=key_words, pos_bits=pos_bits, wide=wide,
        flat_cap=flat_cap,
    )


class ChunkOutTail(NamedTuple):
    """Device-tail chunk output: only per-chain summaries + per-read scalars
    leave the device — O(chains) D2H instead of O(anchors).  Carried chain
    anchors (the reference's *_a arrays, rmap.cpp:111-116) stay device-
    resident and feed the next chunk's merge directly."""

    # [B, K, 10] per chain (target-sorted): score, cnt, key(u32 bits),
    # tpos0, qpos0, tposL, qposL, mlen, blen, valid
    summaries: jnp.ndarray
    # [B, 9]: 0 n_chains, 1 rep_len, 2 n_ev, 3 processed, 4 hit_overflow,
    # 5 ev_offset, 6 chain_overflow, 7 prev_overflow, 8 flat_overflow
    # (chains dropped from summ_flat because total live chains > flat_cap;
    # same value replicated on every row)
    scalars: jnp.ndarray
    # device-resident carried anchors for the next chunk
    prev_key: jnp.ndarray  # u32 [B, P_out]
    prev_tpos: jnp.ndarray  # i32 [B, P_out]
    prev_qpos: jnp.ndarray  # i32 [B, P_out]
    n_prev: jnp.ndarray  # i32 [B]
    carry: NormCarry
    ev_offset: jnp.ndarray  # i32 [B]
    # sharded engine only: per-device locally-owned seed-hit totals
    # (i32 [n_devices]) for work-balance observability; None single-device
    shard_hits: jnp.ndarray | None = None
    # flat live-chain summaries i32 [flat_cap, 10] (chains packed
    # back-to-back in batch-row order at cumsum(n_u) offsets) when the
    # step ran with flat_cap > 0; the dense [B, K, 10] `summaries` is a
    # placeholder then.  Fetching the flat buffer moves O(live chains)
    # bytes instead of O(B*k_cap) — 185 MB -> ~2 MB per D4 chunk.
    summ_flat: jnp.ndarray | None = None


@functools.partial(
    jax.jit,
    static_argnames=(
        "diff", "w", "e", "q", "k",
        "fine_min", "fine_max", "fine_range",
        "window_length1", "window_length2",
        "threshold1", "threshold2", "peak_height",
        "e_cap", "a_cap", "k_cap", "p_out",
        "min_events", "mid_occ",
        "max_dist_t", "max_dist_q", "bw", "max_iter",
        "chn_pen_gap", "chn_pen_skip",
        "min_cnt", "min_sc",
        "all_vs_all", "flat_cap",
    ),
)
def chunk_step_tail(
    didx: DeviceIndex,
    sig: jnp.ndarray,  # f16/f32 [B, L]
    carry: NormCarry,
    ev_offset: jnp.ndarray,  # i32 [B]
    prev_key: jnp.ndarray,  # u32 [B, P_in] device-resident carried anchors
    prev_tpos: jnp.ndarray,  # i32 [B, P_in]
    prev_qpos: jnp.ndarray,  # i32 [B, P_in]
    n_prev: jnp.ndarray,  # i32 [B]
    active: jnp.ndarray,  # i32 [B] 1 = read still mapping (keeps its carry)
    slen: jnp.ndarray,  # i32 [B]
    q_rank: jnp.ndarray,  # i32 [B]
    target_rank: jnp.ndarray,  # i32 [n_seq]
    *,
    diff: float, w: int, e: int, q: int, k: int,
    fine_min: float, fine_max: float, fine_range: float,
    window_length1: int, window_length2: int,
    threshold1: float, threshold2: float, peak_height: float,
    e_cap: int, a_cap: int, k_cap: int, p_out: int,
    min_events: int, mid_occ: int,
    max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    min_cnt: int, min_sc: int,
    all_vs_all: bool, flat_cap: int = 0,
) -> ChunkOutTail:
    """The fused device-tail chunk step: everything chunk_step does PLUS the
    chain backtrack/compaction on-device (reference: the whole per-chunk body
    of ri_map_frag + mg_chain_backtrack + compact_a, rmap.cpp:210-387,
    lchain.c:95-281).  The host receives per-chain summaries only."""
    span = k + e - 1
    sig = sig.astype(jnp.float32)
    n_prev = jnp.where(active != 0, n_prev, 0)

    events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid = (
        events_and_sketch(
            sig, slen, carry,
            window_length1=window_length1, window_length2=window_length2,
            threshold1=threshold1, threshold2=threshold2,
            peak_height=peak_height, e_cap=e_cap, min_events=min_events,
            diff=diff, w=w, e=e, q=q, k=k,
            fine_min=fine_min, fine_max=fine_max, fine_range=fine_range,
        )
    )
    ev_offset2 = ev_offset + jnp.where(processed, n_ev, 0)

    start, count = lookup_counts(didx, hashes, seed_valid)
    flt = count > mid_occ
    rep_len = rep_len_from_filtered(qpos_seed, flt, span)
    count = jnp.where(flt, 0, count)

    seed_c, hit_id, hit_ps, slot_valid, n_hits, overflow = expand_hits(
        didx, start, count, a_cap
    )
    a_qpos = jnp.take_along_axis(qpos_seed, seed_c, axis=1) + ev_offset[:, None]
    a_key = ((hit_ps & 1) << 31) | hit_id
    a_tpos = ((hit_ps >> 1) & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)

    return tail_finish(
        a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
        rep_len, n_ev, processed, carry2, ev_offset2,
        prev_key, prev_tpos, prev_qpos, n_prev,
        q_rank, target_rank,
        span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
        all_vs_all=all_vs_all,
        min_cnt=min_cnt, min_sc=min_sc, k_cap=k_cap, p_out=p_out,
        flat_cap=flat_cap,
    )


def tail_finish(
    a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
    rep_len, n_ev, processed, carry2, ev_offset2,
    prev_key, prev_tpos, prev_qpos, n_prev,
    q_rank, target_rank,
    *, span: int, max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float, all_vs_all: bool,
    min_cnt: int, min_sc: int, k_cap: int, p_out: int,
    flat_cap: int = 0,
) -> ChunkOutTail:
    """Everything after the seed expansion in the device-tail step: the
    per-read merge/sort/fill, on-device backtrack + compaction and carried
    anchor re-pick.  Pure data parallelism over the batch dimension — also
    the per-device body of the sharded tail (parallel/dist.py), which swaps
    only the lookup stage."""
    from ..chain.backtrack_device import backtrack_batch, compact_batch
    s_key, s_tpos, s_qpos, n_anchors, f, p = merge_sort_fill(
        a_key, a_tpos, a_qpos, slot_valid, n_hits,
        prev_key, prev_tpos, prev_qpos, n_prev,
        q_rank, target_rank,
        span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
        all_vs_all=all_vs_all,
    )

    # --- on-device backtrack + compaction (lchain.c:95-281) ---
    u_sc, u_cnt, n_u, v, n_v, chain_ovf = backtrack_batch(
        f, p, n_anchors,
        min_cnt=min_cnt, min_sc=min_sc, max_drop=bw, k_cap=k_cap,
    )
    asc, _, summaries = compact_batch(
        u_sc, u_cnt, n_u, v, n_v, s_key, s_tpos, s_qpos, q_span=span
    )

    # carried anchors for the next chunk, device-resident (chain-major
    # discovery order — the reference's *_a layout)
    take = jnp.minimum(n_v, p_out)
    pslots = jnp.arange(p_out, dtype=jnp.int32)
    # p_out may exceed the live anchor width; slots past n_v are masked
    sel = jnp.clip(
        asc[:, jnp.clip(pslots, 0, asc.shape[1] - 1)], 0, s_key.shape[1] - 1
    )
    pvalid = pslots[None, :] < take[:, None]
    pk = jnp.where(pvalid, jnp.take_along_axis(s_key, sel, axis=1), U32_MAX)
    pt = jnp.where(
        pvalid, jnp.take_along_axis(s_tpos, sel, axis=1), jnp.int32(0)
    )
    pq = jnp.where(
        pvalid, jnp.take_along_axis(s_qpos, sel, axis=1), jnp.int32(0)
    )
    prev_ovf = jnp.maximum(n_v - p_out, 0)

    summ_flat = None
    flat_ovf = jnp.zeros_like(n_u)
    if flat_cap:
        # pack live chains back-to-back (batch-row order) so the host
        # fetches O(live chains) bytes; rows beyond a read's n_u scatter
        # out of bounds and drop
        b = n_u.shape[0]
        offs = jnp.cumsum(n_u) - n_u
        kidx = jnp.arange(summaries.shape[1], dtype=jnp.int32)[None, :]
        live = kidx < n_u[:, None]
        gpos = jnp.where(live, offs[:, None] + kidx, flat_cap)
        summ_flat = (
            jnp.zeros((flat_cap, 10), jnp.int32)
            .at[gpos.reshape(-1)]
            .set(summaries.reshape(-1, 10), mode="drop")
        )
        total = jnp.sum(n_u)
        flat_ovf = jnp.broadcast_to(
            jnp.maximum(total - flat_cap, 0), n_u.shape
        )
        summaries = jnp.zeros((b, 1, 10), jnp.int32)

    scalars = jnp.stack(
        [
            n_u, rep_len, n_ev, processed.astype(jnp.int32),
            overflow.astype(jnp.int32), ev_offset2, chain_ovf, prev_ovf,
            flat_ovf,
        ],
        axis=1,
    ).astype(jnp.int32)
    return ChunkOutTail(
        summaries=summaries, scalars=scalars,
        prev_key=pk, prev_tpos=pt, prev_qpos=pq, n_prev=take,
        carry=carry2, ev_offset=ev_offset2, summ_flat=summ_flat,
    )


@functools.partial(jax.jit, static_argnames=("ncut",))
def gather_rows_prefix(packed: jnp.ndarray, rows: jnp.ndarray, *, ncut: int):
    """Row-sliced prefix of the packed-anchor buffer: packed[rows, :ncut].

    Late chunks of a batch have only a handful of live reads, but a
    full-buffer fetch still moves b_dev * ncut * words bytes.  `rows` is a
    TRACED argument (padded to a pow2 ladder), so one compiled program per
    (ncut, n_rows) signature serves every straggler pattern.

    Formulated as slice-then-take: the advanced-indexing form
    packed[rows, :ncut] can lower to a gather that materializes the whole
    [rows, N] index space."""
    prefix = jax.lax.slice_in_dim(packed, 0, ncut, axis=1)
    return jnp.take(prefix, rows, axis=0)


# AOT-memoized entries used by the engine (see AotMemo docstring)
chunk_step_aot = AotMemo(chunk_step)
chunk_step_tail_aot = AotMemo(chunk_step_tail)
gather_rows_aot = AotMemo(gather_rows_prefix)
