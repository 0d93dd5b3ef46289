"""Anchor-capacity growth + wide packing: the engine never truncates hits.

Reference semantics: hit vectors grow dynamically and are never cut
(rh_kvec, rseed.c:105-154); chain anchors all carry to the next chunk
(rmap.cpp:111-116).  The device engine uses static shapes, so it instead
re-runs an overflowed chunk at doubled capacity (exact: carry state is
committed only after the retry) and escalates the D2H packing from the
narrow i16 layout to the wide i32 layout past the 2^15 range.
"""

import numpy as np
import pytest

from rawhash_tpu.config import IndexOptions, MapOptions
from rawhash_tpu.index.build import build_index_from_sequences
from rawhash_tpu.io.signal_gen import simulate_reads
from rawhash_tpu.map.engine import MappingEngine
from rawhash_tpu.pore import synthetic_pore


def _fixture(repeat_dense=False, seed=11, n_reads=6):
    rng = np.random.default_rng(seed)
    pore = synthetic_pore(k=6)
    if repeat_dense:
        # tandem-repeat genome: one 200 bp unit repeated with light noise,
        # so nearly every seed has high occurrence
        unit = "".join(rng.choice(list("ACGT"), size=200))
        parts = []
        for _ in range(40):
            u = list(unit)
            for j in rng.integers(0, 200, size=4):
                u[j] = "ACGT"[rng.integers(0, 4)]
            parts.append("".join(u))
        genome = "".join(parts) + "".join(rng.choice(list("ACGT"), size=2000))
    else:
        genome = "".join(rng.choice(list("ACGT"), size=8000))
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=n_reads, read_len=600, rng=rng)
    return index, reads


def _key(res):
    out = []
    for r in res:
        out.append(
            (r.name, [(m.mapped, m.ref_id, m.frag_start, m.frag_len, m.rev, m.mapq)
                      for m in r.records])
        )
    return out


def test_wide_packing_matches_narrow():
    """Forcing the wide i32 layout must not change any mapping output."""
    index, reads = _fixture()
    batch = [(n, s) for n, s, _, _ in reads]

    mo = MapOptions()
    mo.max_anchors_per_read = 1024
    narrow = MappingEngine(index, mo).map_batch(batch)

    mo2 = MapOptions()
    mo2.max_anchors_per_read = 1024
    # e_cap * max_num_chunk >= 32700 trips the wide layout in _BatchState
    mo2.max_num_chunk = 50
    wide = MappingEngine(index, mo2).map_batch(batch)
    assert _key(narrow) == _key(wide)
    assert any(m.mapped for r in narrow for m in r.records)


def test_overflow_retry_growth_matches_big_capacity():
    """On a repeat-dense genome a tiny initial a_cap must grow (not drop
    hits): results equal an engine given generous capacity up front, and the
    residual hit_overflow counter stays zero."""
    index, reads = _fixture(repeat_dense=True)
    batch = [(n, s) for n, s, _, _ in reads]

    big = MapOptions()
    big.max_anchors_per_read = 1 << 15  # generous from the start
    big.mid_occ = 200
    eng_big = MappingEngine(index, big)
    res_big = eng_big.map_batch(batch)

    small = MapOptions()
    small.max_anchors_per_read = 512  # will overflow on chunk 1
    small.mid_occ = 200
    eng_small = MappingEngine(index, small)
    res_small = eng_small.map_batch(batch)

    assert eng_small.stats.get("anchor_regrows", 0) > 0
    assert eng_small.stats["hit_overflow"] == 0
    assert _key(res_small) == _key(res_big)


def test_growth_disabled_reports_overflow():
    index, reads = _fixture(repeat_dense=True)
    batch = [(n, s) for n, s, _, _ in reads]
    mo = MapOptions()
    mo.max_anchors_per_read = 512
    mo.max_anchor_cap = 0  # growth off: overflow is counted, not fixed
    mo.mid_occ = 200
    eng = MappingEngine(index, mo)
    eng.map_batch(batch)
    assert eng.stats["hit_overflow"] > 0


def test_occ_stats_sizing():
    index, _ = _fixture(repeat_dense=True)
    mo = MapOptions()
    eng = MappingEngine(index, mo)
    mu, sigma = eng._occ_stats()
    # tandem genome: position-weighted occupancy far above the key-mean
    counts = index.counts()
    key_mean = counts.mean()
    assert mu > key_mean
    assert sigma >= 0.0
    l_chunk, max_chunk, e_cap, a_cap, p_cap = eng._plan(np.array([4000]))
    assert a_cap >= 512
