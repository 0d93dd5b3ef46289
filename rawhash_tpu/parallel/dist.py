"""Multi-chip distribution: hash-range index sharding + collective seed merge.

The reference is single-node with a shared in-RAM khash (SURVEY.md §2.4); the
multi-device scale-out axis is net-new.  The design:

  * the CSR seed table is split into `n_shards` contiguous hash ranges, each
    shard's offsets rebased to its local position slice (shard_index)
  * the mesh is 2D (dp, shard): the table rides `shard`; read batches ride
    BOTH axes flattened — every per-read stage (events, sketch, sort, chain
    fill) is pure data parallelism over all dp*shard devices
  * the WHOLE chunk step runs inside one shard_map.  The only cross-device
    communication is the seed-hit merge: `all_gather` the shard-column's
    query hashes over `shard`, probe the local key range, then
    `psum_scatter` the expanded anchor planes back (each global key has
    exactly one owner shard, so the sums are exact merges and slot
    assignment is identical to the single-device CSR expansion)
  * everything after the lookup is the SAME code as the single-device step
    (map/device_step.py::finish_chunk): prev-anchor carry, rep_len,
    all-vs-all filter, chain fill — so sharded PAF == single PAF

With n_shards=1 the collectives are no-ops and this is pure DP; with one
process per host, `jax.distributed.initialize` (parallel/multihost.py) + the
same mesh spans hosts.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.build import RawIndex
from ..map.device_step import (
    ChunkOut,
    ChunkOutTail,
    decode_prev_pack,
    events_and_sketch,
    finish_chunk,
    rep_len_from_filtered,
    tail_finish,
)
from ..signal.events import NormCarry

U32_MAX = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class ShardedIndexArrays:
    """Host-side sharded table: dim 0 is the shard axis."""

    keys: np.ndarray  # u32 [S, Kpad] sorted per shard, U32_MAX padded
    offsets: np.ndarray  # i32 [S, Kpad+1] local CSR offsets
    pos_id: np.ndarray  # u32 [S, Npad]
    pos_ps: np.ndarray  # u32 [S, Npad]
    n_seq: int


def shard_index(index: RawIndex, n_shards: int) -> ShardedIndexArrays:
    """Split the CSR table into n_shards equal-key hash ranges."""
    k = index.keys.shape[0]
    bounds = [(s * k) // n_shards for s in range(n_shards + 1)]
    kpad = max(1, max(bounds[s + 1] - bounds[s] for s in range(n_shards)))
    npad = 1
    slices = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        o = index.offsets[lo : hi + 1]
        npad = max(npad, int(o[-1] - o[0]))
        slices.append((lo, hi, o))
    keys = np.full((n_shards, kpad), U32_MAX, dtype=np.uint32)
    offsets = np.zeros((n_shards, kpad + 1), dtype=np.int32)
    pos_id = np.zeros((n_shards, npad), dtype=np.uint32)
    pos_ps = np.zeros((n_shards, npad), dtype=np.uint32)
    for s, (lo, hi, o) in enumerate(slices):
        nk = hi - lo
        keys[s, :nk] = index.keys[lo:hi]
        local = (o - o[0]).astype(np.int32)
        offsets[s, : nk + 1] = local
        offsets[s, nk + 1 :] = local[-1]
        run = index.pos[o[0] : o[-1]]
        pos_id[s, : run.shape[0]] = (run >> np.uint64(32)).astype(np.uint32)
        pos_ps[s, : run.shape[0]] = (run & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return ShardedIndexArrays(keys, offsets, pos_id, pos_ps, index.n_seq)


def make_mesh(n_devices: int | None = None, n_shards: int = 2) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devs)
    n_shards = min(n_shards, n)
    dp = n // n_shards
    return Mesh(np.array(devs[: dp * n_shards]).reshape(dp, n_shards), ("dp", "shard"))


def _local_lookup(keys, offsets, hashes, valid):
    """Per-shard binary-search lookup (device-local key range)."""
    kpad = keys.shape[0]
    i = jnp.searchsorted(keys, hashes.reshape(-1), side="left").reshape(hashes.shape)
    i_c = jnp.clip(i, 0, kpad - 1)
    found = valid & (keys[i_c] == hashes) & (hashes != jnp.uint32(0xFFFFFFFF))
    start = offsets[i_c]
    count = jnp.where(found, offsets[jnp.clip(i_c + 1, 0, kpad)] - start, 0)
    return jnp.where(found, start, 0), count.astype(jnp.int32), found


def _sharded_lookup_expand(
    keys, offsets, pos_id, pos_ps,
    hashes, qpos_seed, valid, ev_offset, mid_occ: int, a_cap: int,
):
    """Seed lookup + CSR expansion across the `shard` axis.

    Runs inside shard_map.  hashes/qpos/valid are this device's local batch
    rows; the table args are this device's hash-range shard.  Produces the
    SAME anchors in the SAME slots as index/device.py::expand_hits on the
    unsharded table: global slot assignment comes from the psum-merged
    per-seed counts, each slot is filled by its key's unique owner shard,
    and psum_scatter returns the merged rows to their batch owners.
    """
    n_sh = jax.lax.axis_size("shard")
    bl = hashes.shape[0]
    # every shard needs every batch row of its shard column: gather queries
    hash_g = jax.lax.all_gather(hashes, "shard", axis=0, tiled=True)
    valid_g = jax.lax.all_gather(valid, "shard", axis=0, tiled=True)
    start, count_l, found = _local_lookup(keys, offsets, hash_g, valid_g)
    count_g = jax.lax.psum(count_l, "shard")  # exact: one owner per key
    flt = count_g > mid_occ
    count_g = jnp.where(flt, 0, count_g)

    # global slot assignment, identical on every shard after the psum
    # (same marker+cummax construction as index/device.py::expand_hits)
    bg, s = count_g.shape
    ccum = jnp.cumsum(count_g, axis=1)
    n_hits_full = ccum[:, -1]
    n_hits = jnp.minimum(n_hits_full, a_cap)
    cum_before = ccum - count_g
    slots = jax.lax.broadcasted_iota(jnp.int32, (bg, a_cap), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (bg, s), 0)
    tgt = jnp.where((count_g > 0) & (cum_before < a_cap), cum_before, a_cap)
    seed_ids = jax.lax.broadcasted_iota(jnp.int32, (bg, s), 1)
    marker = (
        jnp.zeros((bg, a_cap + 1), jnp.int32)
        .at[rows, tgt]
        .max(seed_ids)[:, :a_cap]
    )
    seed_c = jax.lax.cummax(marker, axis=1)
    slot_valid = slots < n_hits[:, None]
    occ = slots - jnp.take_along_axis(cum_before, seed_c, axis=1)
    mine = jnp.take_along_axis(found & (~flt), seed_c, axis=1) & slot_valid
    fetch = jnp.take_along_axis(start, seed_c, axis=1) + occ
    fetch = jnp.where(mine, fetch, 0)
    hid = jnp.where(mine, pos_id[fetch], jnp.uint32(0)).astype(jnp.int32)
    hps = jnp.where(mine, pos_ps[fetch], jnp.uint32(0)).astype(jnp.int32)
    # merge shard contributions and return each device its own batch block
    # (sum over `shard` is exact: exactly one shard owns each slot's key)
    hid = jax.lax.psum_scatter(hid, "shard", scatter_dimension=0, tiled=True)
    hps = jax.lax.psum_scatter(hps, "shard", scatter_dimension=0, tiled=True)
    hid = hid.astype(jnp.uint32)
    hps = hps.astype(jnp.uint32)

    # slice the replicated per-row stats back to this device's batch block
    my = jax.lax.axis_index("shard") * bl
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, my, bl, 0)
    seed_c_l = sl(seed_c)
    a_qpos = jnp.take_along_axis(qpos_seed, seed_c_l, axis=1) + ev_offset[:, None]
    a_key = ((hps & 1) << 31) | hid
    a_tpos = ((hps >> 1) & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    # per-device work-balance observable: seed hits owned by THIS shard
    # (sum of its local post-filter counts over the whole gathered batch)
    local_hits = jnp.sum(jnp.where(flt, 0, count_l)).astype(jnp.int32)
    return (
        a_key, a_tpos, a_qpos,
        sl(slot_valid), sl(n_hits), sl(jnp.maximum(n_hits_full - a_cap, 0)),
        sl(flt), local_hits,
    )


@functools.lru_cache(maxsize=64)
def _build_dist_step(mesh: Mesh, statics: tuple):
    """Trace-and-cache one sharded chunk step per (mesh, param set)."""
    st = dict(statics)
    span = st["k"] + st["e"] - 1
    bspec = P(("dp", "shard"))  # batch over ALL devices
    tspec = P("shard", None)  # table over the shard axis

    def body(
        keys, offsets, pos_id, pos_ps,
        sig, c_sum, c_sumsq, c_n, ev_offset, prev_pack, q_rank, target_rank,
    ):
        keys, offsets = keys[0], offsets[0]
        pos_id, pos_ps = pos_id[0], pos_ps[0]
        sig = sig.astype(jnp.float32)
        carry = NormCarry(c_sum, c_sumsq, c_n)
        prev_key, prev_tpos, prev_qpos, n_prev, slen = decode_prev_pack(prev_pack)
        events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid = (
            events_and_sketch(
                sig, slen, carry,
                window_length1=st["window_length1"],
                window_length2=st["window_length2"],
                threshold1=st["threshold1"], threshold2=st["threshold2"],
                peak_height=st["peak_height"], e_cap=st["e_cap"],
                min_events=st["min_events"],
                diff=st["diff"], w=st["w"], e=st["e"], q=st["q"], k=st["k"],
                fine_min=st["fine_min"], fine_max=st["fine_max"],
                fine_range=st["fine_range"],
            )
        )
        ev_offset2 = ev_offset + jnp.where(processed, n_ev, 0)
        a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow, flt, local_hits = (
            _sharded_lookup_expand(
                keys, offsets, pos_id, pos_ps,
                hashes, qpos_seed, seed_valid, ev_offset,
                st["mid_occ"], st["a_cap"],
            )
        )
        rep_len = rep_len_from_filtered(qpos_seed, flt, span)
        out = finish_chunk(
            a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
            rep_len, events, n_ev, processed, carry2, ev_offset2,
            prev_key, prev_tpos, prev_qpos, n_prev,
            q_rank, target_rank,
            span=span,
            max_dist_t=st["max_dist_t"], max_dist_q=st["max_dist_q"],
            bw=st["bw"], max_iter=st["max_iter"],
            chn_pen_gap=st["chn_pen_gap"], chn_pen_skip=st["chn_pen_skip"],
            all_vs_all=st["all_vs_all"], keep_events=st["keep_events"],
            key_words=st["key_words"], pos_bits=st["pos_bits"],
            wide=st.get("wide", False),
        )
        return (
            out.packed, out.scalars, out.events,
            out.carry.sum, out.carry.sum_sq, out.carry.n, out.ev_offset,
            local_hits[None],
        )

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            tspec, tspec, tspec, tspec,
            P(("dp", "shard"), None), bspec, bspec, bspec, bspec,
            P(("dp", "shard"), None), bspec, P(),
        ),
        out_specs=(
            P(("dp", "shard"), None, None), P(("dp", "shard"), None),
            P(("dp", "shard"), None), bspec, bspec, bspec, bspec,
            P(("dp", "shard")),
        ),
        check_vma=False,
    )
    return jax.jit(mapped)


@functools.lru_cache(maxsize=64)
def _build_dist_step_tail(mesh: Mesh, statics: tuple):
    """The sharded device-tail chunk step: same lookup/merge collectives as
    _build_dist_step, then the per-read tail (merge/sort/fill + on-device
    backtrack/compaction, device_step.tail_finish) — pure data parallelism,
    so carried chain anchors stay device-resident WITH their batch sharding
    and only O(chains) summaries leave the mesh."""
    st = dict(statics)
    span = st["k"] + st["e"] - 1
    bspec = P(("dp", "shard"))
    brow = P(("dp", "shard"), None)
    tspec = P("shard", None)

    def body(
        keys, offsets, pos_id, pos_ps,
        sig, c_sum, c_sumsq, c_n, ev_offset,
        prev_key, prev_tpos, prev_qpos, n_prev, active, slen,
        q_rank, target_rank,
    ):
        keys, offsets = keys[0], offsets[0]
        pos_id, pos_ps = pos_id[0], pos_ps[0]
        sig = sig.astype(jnp.float32)
        carry = NormCarry(c_sum, c_sumsq, c_n)
        n_prev = jnp.where(active != 0, n_prev, 0)
        events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid = (
            events_and_sketch(
                sig, slen, carry,
                window_length1=st["window_length1"],
                window_length2=st["window_length2"],
                threshold1=st["threshold1"], threshold2=st["threshold2"],
                peak_height=st["peak_height"], e_cap=st["e_cap"],
                min_events=st["min_events"],
                diff=st["diff"], w=st["w"], e=st["e"], q=st["q"], k=st["k"],
                fine_min=st["fine_min"], fine_max=st["fine_max"],
                fine_range=st["fine_range"],
            )
        )
        ev_offset2 = ev_offset + jnp.where(processed, n_ev, 0)
        a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow, flt, local_hits = (
            _sharded_lookup_expand(
                keys, offsets, pos_id, pos_ps,
                hashes, qpos_seed, seed_valid, ev_offset,
                st["mid_occ"], st["a_cap"],
            )
        )
        rep_len = rep_len_from_filtered(qpos_seed, flt, span)
        out = tail_finish(
            a_key, a_tpos, a_qpos, slot_valid, n_hits, overflow,
            rep_len, n_ev, processed, carry2, ev_offset2,
            prev_key, prev_tpos, prev_qpos, n_prev,
            q_rank, target_rank,
            span=span,
            max_dist_t=st["max_dist_t"], max_dist_q=st["max_dist_q"],
            bw=st["bw"], max_iter=st["max_iter"],
            chn_pen_gap=st["chn_pen_gap"], chn_pen_skip=st["chn_pen_skip"],
            all_vs_all=st["all_vs_all"],
            min_cnt=st["min_cnt"], min_sc=st["min_sc"],
            k_cap=st["k_cap"], p_out=st["p_out"],
        )
        return (
            out.summaries, out.scalars,
            out.prev_key, out.prev_tpos, out.prev_qpos, out.n_prev,
            out.carry.sum, out.carry.sum_sq, out.carry.n, out.ev_offset,
            local_hits[None],
        )

    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            tspec, tspec, tspec, tspec,
            brow, bspec, bspec, bspec, bspec,
            brow, brow, brow, bspec, bspec, bspec,
            bspec, P(),
        ),
        out_specs=(
            P(("dp", "shard"), None, None), brow,
            brow, brow, brow, bspec,
            bspec, bspec, bspec, bspec,
            P(("dp", "shard")),
        ),
        check_vma=False,
    )
    return jax.jit(mapped)


def mp_put(arr, sharding):
    """device_put that also works when the mesh spans processes: each
    process materializes only its addressable shards from the (identical)
    host value.  Device arrays (chunk-step outputs fed back as carries) pass
    through — they already carry the step's out_spec sharding."""
    if isinstance(arr, jax.Array) and not isinstance(arr, np.ndarray):
        return arr
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding, lambda i: arr[i])


class DistContext:
    """Everything the MappingEngine needs to run chunks on a (dp, shard)
    mesh: the mesh, device-resident sharded table, and cached jitted steps."""

    def __init__(self, index: RawIndex, mesh: Mesh):
        self.mesh = mesh
        self.n_devices = mesh.devices.size
        sharded = shard_index(index, mesh.shape["shard"])
        tspec = NamedSharding(mesh, P("shard", None))
        self.keys = mp_put(sharded.keys, tspec)
        self.offsets = mp_put(sharded.offsets, tspec)
        self.pos_id = mp_put(sharded.pos_id, tspec)
        self.pos_ps = mp_put(sharded.pos_ps, tspec)
        self.bspec = NamedSharding(mesh, P(("dp", "shard")))
        self.bspec2 = NamedSharding(mesh, P(("dp", "shard"), None))
        self.rspec = NamedSharding(mesh, P())

    def pad_batch(self, b: int) -> int:
        n = self.n_devices
        return ((b + n - 1) // n) * n

    def step(self, sig, carry, ev_offset, prev_pack, q_rank, target_rank,
             **statics) -> ChunkOut:
        fn = _build_dist_step(self.mesh, tuple(sorted(statics.items())))
        put = lambda a, s: mp_put(a, s)
        (packed, scalars, events, c_sum, c_sumsq, c_n, ev_off2, shard_hits) = fn(
            self.keys, self.offsets, self.pos_id, self.pos_ps,
            put(sig, self.bspec2),
            put(carry.sum, self.bspec), put(carry.sum_sq, self.bspec),
            put(carry.n, self.bspec),
            put(ev_offset, self.bspec), put(prev_pack, self.bspec2),
            put(q_rank, self.bspec), put(target_rank, self.rspec),
        )
        return ChunkOut(
            packed=packed, scalars=scalars, events=events,
            carry=NormCarry(c_sum, c_sumsq, c_n), ev_offset=ev_off2,
            shard_hits=shard_hits,
        )

    def step_tail(self, sig, carry, ev_offset,
                  prev_key, prev_tpos, prev_qpos, n_prev, active, slen,
                  q_rank, target_rank, **statics) -> ChunkOutTail:
        fn = _build_dist_step_tail(self.mesh, tuple(sorted(statics.items())))
        put = lambda a, s: mp_put(a, s)
        (summ, scal, pk, pt, pq, npv, c_sum, c_sumsq, c_n, ev_off2,
         shard_hits) = fn(
            self.keys, self.offsets, self.pos_id, self.pos_ps,
            put(sig, self.bspec2),
            put(carry.sum, self.bspec), put(carry.sum_sq, self.bspec),
            put(carry.n, self.bspec),
            put(ev_offset, self.bspec),
            put(prev_key, self.bspec2), put(prev_tpos, self.bspec2),
            put(prev_qpos, self.bspec2), put(n_prev, self.bspec),
            put(active, self.bspec), put(slen, self.bspec),
            put(q_rank, self.bspec), put(target_rank, self.rspec),
        )
        return ChunkOutTail(
            summaries=summ, scalars=scal,
            prev_key=pk, prev_tpos=pt, prev_qpos=pq, n_prev=npv,
            carry=NormCarry(c_sum, c_sumsq, c_n), ev_offset=ev_off2,
            shard_hits=shard_hits,
        )
