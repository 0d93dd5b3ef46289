"""Multi-device sharding tests on the virtual 8-CPU mesh.

The contract under test: the sharded chunk step is
the FULL mapping step — prev-anchor carry, rep_len, occurrence filter,
all-vs-all filter, chain fill — and a mesh engine produces IDENTICAL PAF to
the single-device engine on a multi-chunk adaptive workload for any shard
count.
"""

import numpy as np
import pytest

from rawhash_tpu.config import IndexOptions, MapOptions
from rawhash_tpu.index.build import build_index_from_sequences
from rawhash_tpu.parallel.dist import make_mesh, shard_index
from rawhash_tpu.pore import synthetic_pore


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    return build_index_from_sequences(
        [("chr1", genome)], synthetic_pore(k=6), IndexOptions()
    )


def test_shard_index_partitions_everything(index):
    sh = shard_index(index, 4)
    assert sh.keys.shape[0] == 4
    total_keys = sum(int((sh.keys[s] != 0xFFFFFFFF).sum()) for s in range(4))
    assert total_keys == index.keys.shape[0]
    # every key's run is intact in its shard
    for s in range(4):
        nk = int((sh.keys[s] != 0xFFFFFFFF).sum())
        for j in range(0, nk, max(1, nk // 7)):
            key = sh.keys[s, j]
            lo, hi = sh.offsets[s, j], sh.offsets[s, j + 1]
            run = (
                sh.pos_id[s, lo:hi].astype(np.uint64) << np.uint64(32)
            ) | sh.pos_ps[s, lo:hi].astype(np.uint64)
            np.testing.assert_array_equal(run, index.get(int(key)))


@pytest.fixture(scope="module")
def workload():
    """Multi-chunk adaptive mapping workload: 12 kb genome, reads long
    enough to span several 4000-sample chunks (carried anchors exercised)."""
    from rawhash_tpu.io.signal_gen import simulate_reads

    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=12000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=12, read_len=1200, rng=rng)
    # prepend a noise prefix to half the reads so their first chunk(s) find
    # no chain and the decision happens later, with carried anchors in play
    out = []
    for i, (n, s, _, _) in enumerate(reads):
        if i % 2 == 0:
            noise = rng.normal(90.0, 9.0, size=6000).astype(np.float32)
            s = np.concatenate([noise, s])
        out.append((n, s))
    return index, out


def _strip_mt(rec):
    tags = [t for t in rec.tags.split("\t") if not t.startswith("mt:f:")]
    return (
        rec.read_length, rec.ref_id, rec.read_start, rec.read_end,
        rec.frag_start, rec.frag_len, rec.mapq, rec.rev, rec.mapped,
        "\t".join(tags),
    )


def _map_all(index, reads, n_shards):
    from rawhash_tpu.map.engine import MappingEngine

    mopt = MapOptions()
    mopt.n_shards = n_shards
    eng = MappingEngine(index, mopt)
    out = eng.map_batch(list(reads))
    return [
        (res.name, [_strip_mt(r) for r in res.records]) for res in out
    ]


def test_sharded_engine_paf_identical(index, workload):
    """8-device-mesh PAF == single-device PAF, n_shards in {1, 2, 4},
    multi-chunk adaptive workload."""
    import jax

    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    w_index, reads = workload
    baseline = _map_all(w_index, reads, n_shards=0)  # single-device path
    assert any(rec[8] for _, recs in baseline for rec in recs), "nothing mapped"
    # reads must exercise the chunk loop (carried anchors across chunks)
    assert any("ci:i:2" in rec[9] or "ci:i:3" in rec[9]
               for _, recs in baseline for rec in recs)
    for n_shards in (1, 2, 4):
        got = _map_all(w_index, reads, n_shards=n_shards)
        assert got == baseline, f"n_shards={n_shards} diverged"


def test_dist_step_runs_all_vs_all(workload):
    """The sharded step honors the all-vs-all name-rank filter (sig-target
    indexing + ALL_CHAINS)."""
    from rawhash_tpu.config import IndexFlag, MapFlag
    from rawhash_tpu.index.build import build_index_from_signals
    from rawhash_tpu.map.engine import MappingEngine

    _, reads = workload
    iopt = IndexOptions()
    iopt.flag |= IndexFlag.SIG_TARGET
    sig_index = build_index_from_signals(
        [(n, s) for n, s in reads[:6]], synthetic_pore(k=6), iopt
    )
    mopt = MapOptions()
    mopt.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE

    def run(n_shards):
        mopt.n_shards = n_shards
        eng = MappingEngine(sig_index, mopt)
        res = eng.map_batch(list(reads[:6]))
        return [
            (r.name, [_strip_mt(m) for m in r.records]) for r in res
        ]

    single = run(0)
    sharded = run(2)
    assert sharded == single
    # all-vs-all: a read never maps to itself or earlier-named targets
    names = [n for n, _ in reads[:6]]
    order = {n: i for i, n in enumerate(sorted(names))}
    for name, recs in single:
        for rec in recs:
            if rec[8]:
                assert order[sig_index.seq_names[rec[1]]] > order[name]


def test_sharded_engine_growth_retry_parity(workload):
    """Overflowed rows in the SHARDED engine quarantine exactly like the
    single-device engine: a tiny initial anchor capacity forces the growth
    path (regrows > 0), hits are never silently truncated, and the PAF still
    matches the single-device engine on the same squeezed capacity."""
    from rawhash_tpu.map.engine import MappingEngine

    w_index, reads = workload

    def run(n_shards):
        mopt = MapOptions()
        mopt.n_shards = n_shards
        # squeeze: force per-chunk hit overflow so the quarantine fires
        mopt.max_anchors_per_read = 128
        mopt.max_anchor_cap = 1 << 14
        eng = MappingEngine(w_index, mopt)
        res = eng.map_batch(list(reads))
        return eng, [
            (r.name, [_strip_mt(m) for m in r.records]) for r in res
        ]

    eng1, single = run(0)
    assert eng1.stats.get("anchor_regrows", 0) > 0, (
        "workload must exercise the growth path"
    )
    assert eng1.stats.get("hit_overflow", 0) == 0, "hits were truncated"
    eng2, sharded = run(2)
    assert eng2.stats.get("anchor_regrows", 0) > 0
    assert eng2.stats.get("hit_overflow", 0) == 0
    assert sharded == single


def test_sharded_engine_shard_hits_observable(workload):
    """The sharded engine reports per-device locally-owned hit totals
    (work-balance observability): present, int64, n_devices-long, total > 0,
    and every shard column owns a nonzero share on a uniform genome."""
    from rawhash_tpu.map.engine import MappingEngine

    w_index, reads = workload
    mopt = MapOptions()
    mopt.n_shards = 4
    eng = MappingEngine(w_index, mopt)
    eng.map_batch(list(reads))
    sh = eng.stats.get("shard_hits")
    assert sh is not None and sh.shape[0] == eng.dist.n_devices
    assert sh.sum() > 0
    n_sh = eng.dist.mesh.shape["shard"]
    per_shard = sh.reshape(-1, n_sh).sum(axis=0)
    assert (per_shard > 0).all(), f"unbalanced shard ownership: {per_shard}"


def test_sharded_engine_device_tail_paf_identical(index, workload, monkeypatch):
    """The sharded engine's DEVICE tail (backtrack/compaction inside the
    shard_map, carried anchors device-resident with their batch sharding)
    produces identical PAF to the single-device host-tail baseline."""
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    w_index, reads = workload
    monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL")
    baseline = _map_all(w_index, reads, n_shards=0)
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    for n_shards in (1, 2):
        got = _map_all(w_index, reads, n_shards=n_shards)
        assert got == baseline, f"device-tail n_shards={n_shards} diverged"
