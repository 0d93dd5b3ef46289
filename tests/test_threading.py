"""Concurrency coverage for the threaded mapping pipeline.

The engine overlaps batches: device dispatch on the caller thread, D2H fetch
+ host chain tail in a worker pool (reference analog: kt_pipeline,
kthread.c:130).  Python has no TSan; the systematic check here is
determinism — the threaded pipeline must produce records identical to the
serial path regardless of pipeline depth, and shared counters must stay
consistent under the worker interleavings.
"""

import numpy as np
import pytest

from rawhash_tpu.config import IndexOptions, MapOptions, set_preset
from rawhash_tpu.index.build import build_index_from_sequences
from rawhash_tpu.io.signal_gen import simulate_reads
from rawhash_tpu.map.engine import MappingEngine
from rawhash_tpu.pore import synthetic_pore


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    genome = "".join(rng.choice(list("ACGT"), size=20_000))
    pore = synthetic_pore(k=6)
    iopt = IndexOptions()
    mopt_proto = MapOptions()
    set_preset("viral", iopt, mopt_proto)
    index = build_index_from_sequences([("chr1", genome)], pore, iopt)
    reads = simulate_reads(genome, pore, n_reads=48, read_len=900, rng=rng)
    batches = [
        [(n, s) for n, s, _, _ in reads[i : i + 8]] for i in range(0, 48, 8)
    ]
    return index, batches


def _records(index, batches, depth):
    mopt = MapOptions()
    set_preset("viral", IndexOptions(), mopt)
    mopt.max_anchors_per_read = 1024
    mopt.pipeline_depth = depth
    engine = MappingEngine(index, mopt)
    out = []
    for results in engine.map_stream(iter(batches)):
        for res in results:
            out.append(
                (res.name,
                 [(m.mapped, m.ref_id, m.read_start, m.read_end,
                   m.frag_start, m.frag_len, m.rev, m.mapq)
                  for m in res.records])
            )
    return out, engine.stats


def test_pipeline_depth_determinism(setup):
    """Depth 1 (serial) and depth 3 (three batches in flight across worker
    threads) must produce identical records in identical order."""
    index, batches = setup
    serial, stats1 = _records(index, batches, depth=1)
    threaded, stats3 = _records(index, batches, depth=3)
    assert serial == threaded
    assert stats1["reads"] == stats3["reads"] == 48
    assert stats1["mapped"] == stats3["mapped"]


def test_repeated_threaded_runs_are_stable(setup):
    """Two threaded runs race the same worker pool; records and shared
    counters (guarded by _stats_lock) must not vary with interleaving."""
    index, batches = setup
    a, sa = _records(index, batches, depth=3)
    b, sb = _records(index, batches, depth=3)
    assert a == b
    assert sa["reads"] == sb["reads"]
    assert sa["mapped"] == sb["mapped"]
    assert sa["hit_overflow"] == sb["hit_overflow"]


def test_warmup_concurrent_with_mapping(setup):
    """warmup_async racing real batches must not corrupt results: the memo
    serializes compiles per signature and the dummy batch touches no
    engine carry state."""
    import os

    index, batches = setup
    mopt = MapOptions()
    set_preset("viral", IndexOptions(), mopt)
    mopt.max_anchors_per_read = 1024
    mopt.batch_reads = 8
    engine = MappingEngine(index, mopt)
    os.environ["RAWHASH_TPU_FORCE_WARMUP"] = "1"
    try:
        th = engine.warmup_async(8)
        out = []
        for results in engine.map_stream(iter(batches)):
            out.extend(results)
        th.join(timeout=120)
    finally:
        os.environ.pop("RAWHASH_TPU_FORCE_WARMUP", None)
    assert len(out) == 48
    # the dummy warmup batch must not leak into stats or results
    assert engine.stats["reads"] == 48
    assert not any(r.name.startswith("__warmup") for r in out)
    serial, _ = _records(index, batches, depth=1)
    got = [
        (res.name,
         [(m.mapped, m.ref_id, m.read_start, m.read_end,
           m.frag_start, m.frag_len, m.rev, m.mapq) for m in res.records])
        for res in out
    ]
    assert got == serial


def test_row_sliced_fetch_paf_identical(monkeypatch):
    """Straggler row-sliced packed fetch (packed[rows, :ncut] gather) must
    produce byte-identical results to the full-frame fetch.  The ladder base
    drops to 2 so a tiny CPU batch with early-deciding reads exercises the
    sliced path on chunks where most rows are done."""
    import numpy as np

    from rawhash_tpu.config import IndexOptions, MapOptions
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map.engine import MappingEngine
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=9000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=8, read_len=700, rng=rng)
    # half the reads get a noise prefix so they stay active into later
    # chunks while the clean half decides on chunk 1 -> row slicing kicks in
    batch = []
    for i, (n, s, _, _) in enumerate(reads):
        if i % 2 == 0:
            s = np.concatenate(
                [rng.normal(90.0, 9.0, 6000).astype(np.float32), s]
            )
        batch.append((n, s))

    def run():
        eng = MappingEngine(index, MapOptions())
        out = eng.map_batch(list(batch))
        return [
            (r.name, [
                (m.read_length, m.ref_id, m.read_start, m.read_end,
                 m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped)
                for m in r.records
            ])
            for r in out
        ]

    monkeypatch.setenv("RAWHASH_TPU_ROW_LADDER_BASE", "2")
    sliced = run()
    monkeypatch.setenv("RAWHASH_TPU_ROW_LADDER_BASE", "1024")
    full = run()
    assert sliced == full


def test_concurrent_map_batch_same_engine():
    """Two threads mapping DIFFERENT batches through the SAME engine must
    produce the same records as sequential runs (the engine's shared state —
    stats dict, profiler, AotMemo caches, learned capacity, speculative
    width — is lock-protected or benign-racy by design; this pins it)."""
    import threading

    import numpy as np

    from rawhash_tpu.config import IndexOptions, MapOptions
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map.engine import MappingEngine
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(33)
    genome = "".join(rng.choice(list("ACGT"), size=8000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=16, read_len=600, rng=rng)
    b1 = [(n, s) for n, s, _, _ in reads[:8]]
    b2 = [(n, s) for n, s, _, _ in reads[8:]]

    def snap(res):
        return [
            (r.name, [(m.ref_id, m.frag_start, m.mapq, m.rev, m.mapped)
                      for m in r.records])
            for r in res
        ]

    eng_seq = MappingEngine(index, MapOptions())
    want1, want2 = snap(eng_seq.map_batch(b1)), snap(eng_seq.map_batch(b2))

    eng = MappingEngine(index, MapOptions())
    got = {}
    errs = []

    def run(key, batch):
        try:
            got[key] = snap(eng.map_batch(batch))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=("b1", b1)),
          threading.Thread(target=run, args=("b2", b2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs, errs
    assert got["b1"] == want1 and got["b2"] == want2
    # shared counters land the same totals as the sequential engine
    assert eng.stats["reads"] == eng_seq.stats["reads"] == 16


def test_stress_pipeline_quarantine_20x(setup):
    """CI-style stress loop: 20 iterations of the
    threaded pipeline (3 batches in flight, worker pool fetching + host
    tails) with capacities squeezed so the quarantine regrow path runs
    CONCURRENTLY with prefetch, under PYTHONDEVMODE-style checks
    (faulthandler armed).  Every iteration must reproduce the serial
    records exactly — the only systematic race check Python affords."""
    import faulthandler

    faulthandler.enable()
    index, batches = setup

    def run(depth, squeeze):
        mopt = MapOptions()
        set_preset("viral", IndexOptions(), mopt)
        mopt.pipeline_depth = depth
        if squeeze:
            # tiny hit capacity: most chunks overflow and take the
            # quarantine sub-batch redispatch concurrently with the pool
            mopt.max_anchors_per_read = 64
            mopt.max_anchor_cap = 1 << 13
        else:
            mopt.max_anchors_per_read = 1024
        engine = MappingEngine(index, mopt)
        out = []
        for results in engine.map_stream(iter(batches)):
            for res in results:
                out.append(
                    (res.name,
                     [(m.mapped, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.rev, m.mapq)
                      for m in res.records])
                )
        return out, engine.stats

    serial, sstats = run(depth=1, squeeze=True)
    assert sstats.get("anchor_regrows", 0) > 0, (
        "squeezed capacities must exercise the quarantine regrow"
    )
    for it in range(20):
        got, stats = run(depth=3, squeeze=True)
        assert got == serial, f"iteration {it} diverged"
        assert stats["reads"] == sstats["reads"]
        assert stats["mapped"] == sstats["mapped"]
        assert stats["hit_overflow"] == sstats["hit_overflow"]


def test_flat_pack_growth_and_dense_parity(monkeypatch):
    """The flat exact-count packed-anchor path must (a) regrow on
    pack_overflow and (b) match the dense fetch path record-for-record."""
    import numpy as np

    from rawhash_tpu.config import IndexOptions, MapOptions
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map.engine import MappingEngine
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), size=14000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=8, read_len=900, rng=rng)
    batch = [(n, s) for n, s, _, _ in reads]

    def run():
        eng = MappingEngine(index, MapOptions())
        out = eng.map_batch(list(batch))
        return eng, [
            (r.name, [(m.ref_id, m.frag_start, m.frag_len, m.mapq, m.rev,
                       m.mapped) for m in r.records])
            for r in out
        ]

    _, dense = run()
    monkeypatch.setenv("RAWHASH_TPU_FLAT_PACK", "1")
    _, flat = run()
    assert flat == dense
    # force a tiny flat cap: the first chunk must overflow, regrow and
    # still produce identical records
    monkeypatch.setenv("RAWHASH_TPU_FP_BASE", "64")
    eng, grown = run()
    assert grown == dense
    assert eng.stats.get("anchor_regrows", 0) > 0
