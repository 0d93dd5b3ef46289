"""Loader for the reference rawhash2 binary index format (.ind).

The reference serializes its index as magic "RI" + params + pore table +
per-sequence metadata (+ optional stored signals) + 2^b hash buckets, each a
raw khash dump (reference: ri_idx_dump, rindex.c:545-648; ri_idx_load,
rindex.c:650-776; ri_idx_is_idx, rindex.c:994-1016).  This module parses
that byte stream into the repo's flat sorted-CSR RawIndex so reference-built
.ind files (as used throughout test/scripts) drop straight into the
mapping engine.

Key reconstruction (reference: worker_post, rindex.c:341 / ri_idx_get,
rindex.c:497-514): a seed with hash value H lives in bucket H & (2^b - 1)
under khash key (H >> b) << 1, with bit 0 set for singletons; singleton
khash values hold the position word y directly, multi-entry values hold
(start << 32 | count) into the bucket's y-sorted p[] array.  So
H = (khkey >> 1) << b | bucket.
"""

from __future__ import annotations

import struct

import numpy as np

from ..config import IndexFlag, IndexOptions
from ..pore import PoreModel
from .build import RawIndex

_MAGIC = b"RI"
_B = 14  # bucket bits: hardwired at load time (rindex.c:670 ri_idx_init(.., 14, ..))


def is_ref_index(path: str) -> bool:
    """Detect the reference's binary index (reference: ri_idx_is_idx)."""
    try:
        with open(path, "rb") as fp:
            return fp.read(2) == _MAGIC
    except (OSError, IsADirectoryError):
        return False


def load_ref_index(path: str) -> RawIndex:
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:2] != _MAGIC:
        raise ValueError(f"{path}: not a reference rawhash2 index")
    off = 2
    w, e, n, q, k, n_seq, flag = struct.unpack_from("<7I", data, off)
    off += 28
    diff, fine_min, fine_max, fine_range = struct.unpack_from("<4f", data, off)
    off += 16

    # ri_pore_t is dumped raw including its two 64-bit pointers
    # (rindex.c:557): {ri_porei_t* (8), float* (8), uint n_pore_vals (4),
    # short k (2), pad (2), float max_val (4), float min_val (4)} = 32 bytes
    n_pore_vals = struct.unpack_from("<I", data, off + 16)[0]
    pore_k = struct.unpack_from("<h", data, off + 20)[0]
    off += 32
    pore_vals = np.frombuffer(data, np.float32, n_pore_vals, off).copy()
    off += 4 * n_pore_vals
    off += 12 * n_pore_vals  # ri_porei_t {f32, u32, u32}: recomputed on use

    sig_target = bool(flag & IndexFlag.SIG_TARGET)
    store_sig = bool(flag & IndexFlag.STORE_SIG)
    no_rev = bool(flag & IndexFlag.NO_REV_TARGET)
    names, lens = [], []
    F = [] if store_sig else None
    R = [] if (store_sig and not no_rev) else None
    for _ in range(n_seq):
        l = data[off]
        off += 1
        names.append(data[off : off + l].decode())
        off += l
        lens.append(struct.unpack_from("<I", data, off)[0])
        off += 4
        if store_sig:
            fl = struct.unpack_from("<I", data, off)[0]
            off += 4
            F.append(np.frombuffer(data, np.float32, fl, off).copy())
            off += 4 * fl
            if not no_rev:
                rl = struct.unpack_from("<I", data, off)[0]
                off += 4
                R.append(np.frombuffer(data, np.float32, rl, off).copy())
                off += 4 * rl

    hashes_parts, pos_parts, count_parts = [], [], []
    for bucket in range(1 << _B):
        bn = struct.unpack_from("<I", data, off)[0]
        off += 4
        p = np.frombuffer(data, np.uint64, bn, off)
        off += 8 * bn
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        if size == 0:
            continue
        kv = np.frombuffer(data, np.uint64, 2 * size, off).reshape(size, 2)
        off += 16 * size
        khkey, val = kv[:, 0], kv[:, 1]
        h = ((khkey >> np.uint64(1)) << np.uint64(_B)) | np.uint64(bucket)
        single = (khkey & np.uint64(1)) != 0
        cnt = np.where(single, 1, val & np.uint64(0xFFFFFFFF)).astype(np.int64)
        hashes_parts.append(h.astype(np.uint32))
        count_parts.append(cnt)
        # gather each key's position run (khash iteration order is arbitrary;
        # global key sort below restores the canonical layout)
        starts = (val >> np.uint64(32)).astype(np.int64)
        runs = [
            np.array([val[i]], np.uint64) if single[i]
            else p[starts[i] : starts[i] + cnt[i]]
            for i in range(size)
        ]
        pos_parts.append(runs)

    if hashes_parts:
        hashes = np.concatenate(hashes_parts)
        counts = np.concatenate(count_parts)
        runs = [r for part in pos_parts for r in part]
        order = np.argsort(hashes, kind="stable")
        keys = hashes[order]
        counts = counts[order]
        pos = np.concatenate([runs[i] for i in order]) if runs else np.zeros(
            0, np.uint64
        )
        offsets = np.zeros(keys.shape[0] + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
    else:
        keys = np.zeros(0, np.uint32)
        offsets = np.zeros(1, np.int64)
        pos = np.zeros(0, np.uint64)

    opts = IndexOptions(
        b=_B, w=w, e=e, n=n, q=q, k=k, diff=float(diff),
        fine_min=float(fine_min), fine_max=float(fine_max),
        fine_range=float(fine_range),
    )
    opts.flag = IndexFlag(flag)
    pore = (
        PoreModel(k=int(pore_k), pore_vals=pore_vals)
        if n_pore_vals else None
    )
    return RawIndex(
        opts=opts,
        seq_names=names,
        seq_lens=np.asarray(lens, np.uint32),
        keys=keys,
        offsets=offsets,
        pos=pos,
        sig_target=sig_target,
        pore=pore,
        F=F,
        R=R,
    )


def dump_ref_index(path: str, index: RawIndex) -> None:
    """Write a RawIndex as the reference binary .ind format, loadable by the
    reference rawhash2 binary (inverse of load_ref_index; format:
    ri_idx_dump, rindex.c:545-648).

    Bucket reconstruction mirrors worker_post (rindex.c:315-345): seed hash
    H lands in bucket H & (2^b - 1) under khash key (H >> b) << 1, bit 0 set
    for singletons; singleton values hold the position word directly,
    multi-entry values hold (start << 32 | count) into the bucket's p[]
    array, whose runs keep the CSR's y-sorted order."""
    o = index.opts
    b = int(getattr(o, "b", 14) or 14)
    if b != 14:
        # the .ind format has no bucket-count field: both the reference
        # loader (ri_idx_init(..., 14, ...), rindex.c:670) and
        # load_ref_index hardwire b=14, so any other b dumps to a file
        # that parses as garbage
        raise ValueError(f".ind format requires b=14 buckets, index has b={b}")
    pore = index.pore
    # the loader decides whether per-sequence signals follow each name from
    # the STORE_SIG flag bit, so presence of F/R must match the flag or the
    # reader's fread stream desyncs
    store_sig = bool(o.flag & IndexFlag.STORE_SIG)
    no_rev = bool(o.flag & IndexFlag.NO_REV_TARGET)
    if store_sig != (index.F is not None):
        raise ValueError(
            f"STORE_SIG flag ({store_sig}) disagrees with stored signals "
            f"(F is {'present' if index.F is not None else 'absent'})"
        )
    if store_sig and not no_rev and index.R is None:
        raise ValueError("STORE_SIG without NO_REV_TARGET requires R signals")

    out = bytearray()
    out += _MAGIC
    out += struct.pack(
        "<7I", o.w, o.e, o.n, o.q, o.k, len(index.seq_names), int(o.flag)
    )
    out += struct.pack(
        "<4f", o.diff, o.fine_min, o.fine_max, o.fine_range
    )
    # ri_pore_t raw struct (32 bytes): two dead pointers, n_pore_vals,
    # k (i16 + 2 pad), max_val, min_val (the loader replaces the pointers)
    if pore is not None:
        vals = np.asarray(pore.pore_vals, np.float32)
        out += struct.pack(
            "<QQIhxxff", 0, 0, vals.shape[0], pore.k,
            float(vals.max()), float(vals.min()),
        )
        out += vals.tobytes()
        sv, si, sr = pore.sorted_pairs()
        inds = np.zeros(vals.shape[0], dtype=[("v", "<f4"), ("i", "<u4"), ("r", "<u4")])
        inds["v"], inds["i"], inds["r"] = sv, si, sr
        out += inds.tobytes()
    else:
        out += struct.pack("<QQIhxxff", 0, 0, 0, o.k, 0.0, 0.0)

    for i, name in enumerate(index.seq_names):
        nb = name.encode()[:255]
        out += struct.pack("<B", len(nb)) + nb
        out += struct.pack("<I", int(index.seq_lens[i]))
        if store_sig:
            f = np.asarray(index.F[i], np.float32)
            out += struct.pack("<I", f.shape[0]) + f.tobytes()
            if not no_rev:
                r = np.asarray(index.R[i], np.float32)
                out += struct.pack("<I", r.shape[0]) + r.tobytes()

    keys = index.keys.astype(np.uint64)
    counts = (index.offsets[1:] - index.offsets[:-1]).astype(np.int64)
    starts = index.offsets[:-1].astype(np.int64)
    bucket_of = (keys & np.uint64((1 << b) - 1)).astype(np.int64)
    khkey = ((keys >> np.uint64(b)) << np.uint64(1)) | (counts == 1).astype(
        np.uint64
    )
    order = np.argsort(bucket_of, kind="stable")
    bounds = np.searchsorted(bucket_of[order], np.arange((1 << b) + 1))
    for bu in range(1 << b):
        sel = order[bounds[bu] : bounds[bu + 1]]
        multi = sel[counts[sel] > 1]
        # p[]: concatenated multi-key runs in this bucket (y-sorted runs)
        runs = [index.pos[starts[j] : starts[j] + counts[j]] for j in multi]
        p = np.concatenate(runs) if runs else np.zeros(0, np.uint64)
        out += struct.pack("<I", p.shape[0])
        out += p.astype("<u8").tobytes()
        out += struct.pack("<I", sel.shape[0])
        if sel.shape[0] == 0:
            continue
        run_start = 0
        mpos = {int(j): None for j in multi}
        for j in multi:
            mpos[int(j)] = run_start
            run_start += int(counts[j])
        for j in sel:
            if counts[j] == 1:
                v = np.uint64(index.pos[starts[j]])
            else:
                v = (np.uint64(mpos[int(j)]) << np.uint64(32)) | np.uint64(
                    counts[j]
                )
            out += struct.pack("<QQ", int(khkey[j]), int(v))

    with open(path, "wb") as fp:
        fp.write(bytes(out))
