"""Index construction: genome (or raw-signal targets) -> flat CSR seed table.

Device-first re-design of the reference's 2^14-bucket khash index
(reference: src/rindex.c).  Rather than pointer-chasing hash buckets, seeds
are stored as three flat arrays:

    keys    uint32 [K]   sorted unique 32-bit seed hashes
    offsets int64  [K+1]  CSR offsets into `pos`
    pos     uint64 [N]    seed locations y = id<<32 | pos<<1 | strand,
                          sorted by (key, y)

This is exactly the information content of the reference's per-bucket
(khash key -> (offset<<32|count)) + `p[]` position arrays
(reference: worker_post, rindex.c:311-363): the bucket split by low hash bits
is a sharding detail we replace with a global sort (and, multi-device, with
hash-range sharding in parallel/).  Query semantics are identical: a hash maps
to a position-sorted run of y values (reference: ri_idx_get, rindex.c:497-514).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..config import IndexFlag, IndexOptions
from ..pore import PoreModel, seq_to_sig
from ..sketch.host import sketch_events_np


@dataclasses.dataclass
class RawIndex:
    """In-memory index artifact (host side)."""

    opts: IndexOptions
    seq_names: list
    seq_lens: np.ndarray  # uint32 [n_seq] (bases, or signal events for sig targets)
    keys: np.ndarray  # uint32 [K]
    offsets: np.ndarray  # int64 [K+1]
    pos: np.ndarray  # uint64 [N]
    sig_target: bool = False
    pore: PoreModel | None = None
    # optional stored expected signals (--store-sig) for DTW evaluation
    F: list | None = None  # list of float32 arrays, forward strand
    R: list | None = None  # list of float32 arrays, reverse strand

    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    @property
    def n_seeds(self) -> int:
        return int(self.pos.shape[0])

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def cal_max_occ(self, frac: float) -> int:
        """Occurrence threshold = (1-frac) quantile of per-key counts, plus 1
        (reference: ri_idx_cal_max_occ, rindex.c:1018-1039)."""
        if frac <= 0.0:
            return np.iinfo(np.int32).max
        counts = self.counts()
        if counts.shape[0] == 0:
            return np.iinfo(np.int32).max
        kth = int((1.0 - frac) * counts.shape[0])
        kth = min(max(kth, 0), counts.shape[0] - 1)
        return int(np.partition(counts, kth)[kth]) + 1

    def get(self, hashval: int):
        """Host-side point query (reference: ri_idx_get, rindex.c:497-514)."""
        i = np.searchsorted(self.keys, np.uint32(hashval))
        if i >= self.keys.shape[0] or self.keys[i] != np.uint32(hashval):
            return np.zeros(0, dtype=np.uint64)
        return self.pos[self.offsets[i] : self.offsets[i + 1]]


def _finalize(seed_hashes, seed_ys, opts, seq_names, seq_lens, sig_target,
              pore, F=None, R=None) -> RawIndex:
    if seed_hashes:
        hashes = np.ascontiguousarray(np.concatenate(seed_hashes))
        ys = np.ascontiguousarray(np.concatenate(seed_ys))
    else:
        hashes = np.zeros(0, dtype=np.uint32)
        ys = np.zeros(0, dtype=np.uint64)
    # sort by (hash, y): y-ascending runs per key, like the reference's
    # radix_sort_64 over each key's position list (rindex.c:350).
    # (hash, y) pairs are unique, so the native bucketed parallel sort and
    # np.lexsort produce the identical order.
    from .._native import sort_seeds_native

    if hashes.shape[0] and sort_seeds_native(hashes, ys):
        pass
    else:
        order = np.lexsort((ys, hashes))
        hashes, ys = hashes[order], ys[order]
    if hashes.shape[0]:
        flags = np.empty(hashes.shape[0], dtype=bool)
        flags[0] = True
        np.not_equal(hashes[1:], hashes[:-1], out=flags[1:])
        starts = np.nonzero(flags)[0]
        keys = hashes[starts]
    else:
        keys = hashes
        starts = np.zeros(0, dtype=np.int64)
    offsets = np.concatenate([starts, [hashes.shape[0]]]).astype(np.int64)
    return RawIndex(
        opts=opts,
        seq_names=list(seq_names),
        seq_lens=np.asarray(seq_lens, dtype=np.uint32),
        keys=keys.astype(np.uint32),
        offsets=offsets,
        pos=ys,
        sig_target=sig_target,
        pore=pore,
        F=F,
        R=R,
    )


def build_index_from_sequences(
    records: Iterable[tuple[str, str]],
    pore: PoreModel,
    opts: IndexOptions,
) -> RawIndex:
    """Build from FASTA records [(name, sequence)] — both strands sketched
    unless NO_REV_TARGET (reference: worker_pipeline step 1, rindex.c:128-184)."""
    from .._native import get_lib, sketch_seq_native

    records = list(records)
    store = bool(opts.flag & IndexFlag.STORE_SIG)
    no_rev = bool(opts.flag & IndexFlag.NO_REV_TARGET)
    names = [name for name, _ in records]
    lens = [len(seq) for _, seq in records]
    strands = (0, 1) if not no_rev else (0,)
    tasks = [
        (rid, strand)
        for rid, (_, seq) in enumerate(records)
        if len(seq) >= pore.k
        for strand in strands
    ]

    import os as _os

    if get_lib() is not None and not _os.environ.get(
        "RAWHASH_TPU_NO_NATIVE_BUILD"
    ):
        # native fast path: per-(sequence, strand) single-pass sketch kernel
        # running on a small thread pool (ctypes releases the GIL), the
        # reference's 3-step threaded build pipeline (rindex.c:921)
        from concurrent.futures import ThreadPoolExecutor

        def run(task):
            rid, strand = task
            seq = records[rid][1]
            if isinstance(seq, str):
                seq = seq.encode()
            return sketch_seq_native(
                seq, pore.pore_vals, pore.k, strand, rid,
                opts.diff, opts.w, opts.e, opts.q,
                opts.fine_min, opts.fine_max, opts.fine_range,
                want_sig=store,
            )

        nw = max(1, min(_os.cpu_count() or 1, 8))
        with ThreadPoolExecutor(max_workers=nw) as pool:
            outs = list(pool.map(run, tasks))
        by_task = dict(zip(tasks, outs))
    else:
        by_task = None

    seed_hashes, seed_ys = [], []
    F = [] if store else None
    R = [] if (store and not no_rev) else None
    for rid, (name, seq) in enumerate(records):
        if len(seq) < pore.k:
            if store:
                F.append(np.zeros(0, np.float32))
                if R is not None:
                    R.append(np.zeros(0, np.float32))
            continue
        for strand in strands:
            if by_task is not None:
                out = by_task[(rid, strand)]
                h, y = out[0], out[1]
                sig = out[2] if store else None
            else:
                sig = seq_to_sig(seq, pore, strand)
                h, y = sketch_events_np(
                    sig, rid, strand, opts.diff, opts.w, opts.e, opts.q,
                    opts.k, opts.fine_min, opts.fine_max, opts.fine_range,
                )
            if store:
                (F if strand == 0 else R).append(sig)
            seed_hashes.append(h)
            seed_ys.append(y)
    return _finalize(seed_hashes, seed_ys, opts, names, lens, False, pore, F, R)


def build_index_from_signals(
    reads: Iterable[tuple[str, np.ndarray]],
    pore: PoreModel | None,
    opts: IndexOptions,
) -> RawIndex:
    """Rawsamble path: targets are raw signal reads; each is event-detected
    (or just normalized under NO_EVENT_DETECTION) and sketched on the forward
    strand only (reference: worker_sig_pipeline, rindex.c:274-302)."""
    from ..signal.events_host import detect_events_np, normalize_signal_np

    seed_hashes, seed_ys = [], []
    names, lens = [], []
    store = bool(opts.flag & IndexFlag.STORE_SIG)
    F = [] if store else None
    for rid, (name, sig) in enumerate(reads):
        if opts.flag & IndexFlag.NO_EVENT_DETECTION:
            events, _ = normalize_signal_np(sig, (0.0, 0.0, 0))
        else:
            events, _ = detect_events_np(
                sig, (0.0, 0.0, 0),
                opts.window_length1, opts.window_length2,
                opts.threshold1, opts.threshold2, opts.peak_height,
            )
        names.append(name)
        lens.append(events.shape[0])
        if store:
            F.append(events.astype(np.float32))
        if events.shape[0] == 0:
            continue
        h, y = sketch_events_np(
            events, rid, 0, opts.diff, opts.w, opts.e, opts.q, opts.k,
            opts.fine_min, opts.fine_max, opts.fine_range,
        )
        seed_hashes.append(h)
        seed_ys.append(y)
    return _finalize(seed_hashes, seed_ys, opts, names, lens, True, pore, F, None)


def update_mid_occ(mopt, index: RawIndex) -> int:
    """Derive the occurrence filter threshold from the index
    (reference: ri_mapopt_update, rindex.c:1041-1054)."""
    if mopt.mid_occ <= 0:
        mid = index.cal_max_occ(mopt.mid_occ_frac)
        mid = max(mid, mopt.min_mid_occ)
        if mopt.max_mid_occ > mopt.min_mid_occ:
            mid = min(mid, mopt.max_mid_occ)
        mopt.mid_occ = mid
    if mopt.bw_long < mopt.bw:
        mopt.bw_long = mopt.bw
    return mopt.mid_occ
