"""Device-resident index and batched seed lookup.

The reference probes a khash per query seed (reference: ri_idx_get,
rindex.c:497-514).  On the device the table is three flat arrays and lookup is a
vectorized binary search over the sorted key array (O(log K) gathers per
query, thousands of queries per batch), followed by CSR expansion of the
variable-length position runs into a fixed-capacity anchor buffer — masks
instead of pointers, static shapes throughout.

Seed locations are carried as two uint32 planes (id | pos<<1|strand): JAX
runs without 64-bit integers by default.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .build import RawIndex


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    keys: jnp.ndarray  # uint32 [K] sorted
    offsets: jnp.ndarray  # int32 [K+1]
    pos_id: jnp.ndarray  # uint32 [N]: target id (bit31 unused)
    pos_ps: jnp.ndarray  # uint32 [N]: pos<<1 | strand
    # 2-level lookup acceleration: the reference's 2^b bucket design reborn
    # on the device — prefix[t] = first key index whose top `prefix_bits`
    # equal t, so a query costs 2 prefix gathers + ceil(log2(max bucket))
    # key gathers instead of log2(K) gathers (dependent gathers, so the
    # level count IS the lookup cost)
    prefix: jnp.ndarray  # int32 [2^prefix_bits + 1]
    n_seq: int
    prefix_bits: int
    bucket_levels: int

    @staticmethod
    def from_host(index: RawIndex, device=None) -> "DeviceIndex":
        put = lambda a: jax.device_put(jnp.asarray(a), device)
        pos = index.pos
        keys = index.keys.astype(np.uint32)
        k = keys.shape[0]
        pbits = int(min(20, max(12, int(np.ceil(np.log2(max(k, 2)))) + 2)))
        bounds = (np.arange((1 << pbits) + 1, dtype=np.uint64)
                  << np.uint64(32 - pbits))
        prefix = np.searchsorted(
            keys.astype(np.uint64), bounds, side="left"
        ).astype(np.int32)
        max_bucket = int(np.max(np.diff(prefix))) if k else 0
        levels = 0
        while (1 << levels) < max_bucket:
            levels += 1
        return DeviceIndex(
            keys=put(keys),
            offsets=put(index.offsets.astype(np.int32)),
            pos_id=put((pos >> np.uint64(32)).astype(np.uint32)),
            pos_ps=put((pos & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            prefix=put(prefix),
            n_seq=index.n_seq,
            prefix_bits=pbits,
            bucket_levels=levels,
        )

    def tree_flatten(self):
        return (
            (self.keys, self.offsets, self.pos_id, self.pos_ps, self.prefix),
            (self.n_seq, self.prefix_bits, self.bucket_levels),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, n_seq=aux[0], prefix_bits=aux[1],
                   bucket_levels=aux[2])


jax.tree_util.register_pytree_node(
    DeviceIndex, DeviceIndex.tree_flatten, DeviceIndex.tree_unflatten
)


def lookup_counts(idx: DeviceIndex, hashes: jnp.ndarray, valid: jnp.ndarray):
    """Batched key lookup: hashes [B,S] uint32 -> (start [B,S] i32, count
    [B,S] i32).  count==0 for misses/invalid seeds.

    2-level search: top `prefix_bits` of the hash index the prefix table for
    [lo, hi) bucket bounds, then `bucket_levels` lower-bound halvings inside
    the bucket."""
    k = idx.keys.shape[0]
    if k == 0:
        z = jnp.zeros(hashes.shape, jnp.int32)
        return z, z
    b = (hashes >> jnp.uint32(32 - idx.prefix_bits)).astype(jnp.int32)
    lo = idx.prefix[b]
    hi = idx.prefix[b + 1]
    for _ in range(idx.bucket_levels):
        active = lo < hi
        mid = (lo + hi) >> 1
        kv = idx.keys[jnp.clip(mid, 0, k - 1)]
        go_right = kv < hashes
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    i = lo
    i_c = jnp.clip(i, 0, k - 1)
    found = valid & (i < k) & (idx.keys[i_c] == hashes)
    start = idx.offsets[i_c]
    count = jnp.where(found, idx.offsets[jnp.clip(i_c + 1, 0, k)] - start, 0)
    return jnp.where(found, start, 0), count.astype(jnp.int32)


def expand_hits(
    idx: DeviceIndex,
    start: jnp.ndarray,  # i32 [B, S]
    count: jnp.ndarray,  # i32 [B, S] (already occurrence-filtered)
    a_cap: int,
):
    """CSR expansion of per-seed hit runs into fixed-size anchor slots.

    Returns per-slot (seed_idx [B,A], hit_id [B,A], hit_ps [B,A],
    slot_valid [B,A], n_hits [B], overflow [B]).  Slot n belongs to the seed
    whose cumulative-count interval contains n; the hit is the
    (n - cum_before)-th occurrence of that seed.
    """
    b, s = start.shape
    ccum = jnp.cumsum(count, axis=1)  # inclusive
    n_hits = ccum[:, -1]
    cum_before = ccum - count
    slots = jax.lax.broadcasted_iota(jnp.int32, (b, a_cap), 1)
    # seed for slot n = the seed whose [cum_before, ccum) interval holds n.
    # Seeds with count>0 have unique cum_before values, so scatter each
    # seed's index at its first slot and forward-fill with a running max —
    # one scatter + one cummax instead of a vmapped searchsorted (which is
    # ~10 levels of per-row gathers)
    rows = jax.lax.broadcasted_iota(jnp.int32, (b, s), 0)
    tgt = jnp.where((count > 0) & (cum_before < a_cap), cum_before, a_cap)
    seed_ids = jax.lax.broadcasted_iota(jnp.int32, (b, s), 1)
    marker = (
        jnp.zeros((b, a_cap + 1), jnp.int32)
        .at[rows, tgt]
        .max(seed_ids)[:, :a_cap]
    )
    seed_c = jax.lax.cummax(marker, axis=1)
    slot_valid = slots < jnp.minimum(n_hits, a_cap)[:, None]
    occ = slots - jnp.take_along_axis(cum_before, seed_c, axis=1)
    fetch = jnp.take_along_axis(start, seed_c, axis=1) + occ
    fetch = jnp.where(slot_valid, fetch, 0)
    hit_id = idx.pos_id[fetch]
    hit_ps = idx.pos_ps[fetch]
    overflow = jnp.maximum(n_hits - a_cap, 0)
    return seed_c, hit_id, hit_ps, slot_valid, jnp.minimum(n_hits, a_cap), overflow
