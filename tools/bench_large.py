"""Large-genome mapping characterization (D4 green-algae scale and up).

Builds a synthetic genome of --mbp megabases (optionally repeat-rich), maps
simulated reads with the sensitive preset (the reference's D3/D4 preset,
test/evaluation/read_mapping/d4_green_algae_r94/run_rawhash2.sh), and prints
one JSON line: index-build seconds, device-upload seconds, warmup seconds,
steady bp/s, accuracy, growth-retry counts, and peak RSS.  Exercises the
occupancy/growth path at a scale the default bench.py does not.

  python tools/bench_large.py --mbp 100 --reads 256
  python tools/bench_large.py --mbp 100 --repeat-rich   # growth stress
  python tools/bench_large.py --mbp 100 --reference     # same-host ref run
"""
import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_genome(mbp: float, repeat_rich: bool, rng):
    n = int(mbp * 1_000_000)
    if not repeat_rich:
        # vectorized bytes generation: a Gbp-scale "".join costs minutes and
        # doubles peak memory; the index builder accepts bytes directly
        codes = rng.integers(0, 4, n, dtype=np.uint8)
        return codes.choose(np.frombuffer(b"ACGT", dtype=np.uint8)).tobytes()
    # repeat-rich: 70% unique + a 2 kb unit tiled (with 1% mutations) over
    # the rest — stresses the occurrence filter and the growth-retry path
    uniq = rng.choice(list("ACGT"), size=int(n * 0.7))
    unit = rng.choice(list("ACGT"), size=2000)
    reps = []
    total = 0
    while total < n - uniq.shape[0]:
        u = unit.copy()
        m = rng.random(u.shape[0]) < 0.01
        u[m] = rng.choice(list("ACGT"), size=int(m.sum()))
        reps.append(u)
        total += u.shape[0]
    return "".join(np.concatenate([uniq] + reps))


def run(argv=None) -> dict:
    """Run one large-genome workload; returns the result dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=256)
    ap.add_argument("--read-len", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--repeat-rich", action="store_true")
    ap.add_argument("--reference", action="store_true",
                    help="also run the reference binary on the same workload")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--preset", default="sensitive",
                    help="mapping preset (the reference maps D5 human with "
                         "'fast', optionally -w 3: d5_human_na12878_r94/"
                         "run_rawhash2.sh)")
    ap.add_argument("--w", type=int, default=0,
                    help="minimizer window override (reference human-scale "
                         "runs use -w 3 to halve the seed table)")
    ap.add_argument("--baseline-bps", type=float, default=0.0,
                    help="reference 32-thread bp/s for vs_baseline "
                         "(D4 8390, D5 human 1837; throughput.csv)")
    ap.add_argument("--chrs", type=int, default=1,
                    help="split the genome into this many sequences "
                         "(human-shaped; REQUIRED past 2 Gbp: a single "
                         "sequence overflows the u32 pos<<1|rev packing)")
    args = ap.parse_args(argv)
    if args.mbp * 1e6 / args.chrs >= 2**31:
        ap.error("--chrs too small: per-sequence length must stay < 2^31")

    from rawhash_tpu.config import IndexOptions, MapOptions, set_preset
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map.engine import MappingEngine
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(13)
    t0 = time.time()
    chrs = [
        make_genome(args.mbp / args.chrs, args.repeat_rich, rng)
        for _ in range(args.chrs)
    ]
    genome = chrs[0]
    print(f"# genome: {args.mbp:g} Mbp in {args.chrs} seq(s) "
          f"({'repeat-rich' if args.repeat_rich else 'uniform'}) "
          f"in {time.time()-t0:.1f}s", file=sys.stderr)
    pore = synthetic_pore(k=6)
    iopt = IndexOptions()
    mopt = MapOptions()
    set_preset(args.preset, iopt, mopt)
    if args.w:
        iopt.w = args.w
    mopt.batch_reads = args.batch

    t0 = time.time()
    index = build_index_from_sequences(
        [(f"chr{i+1}", c) for i, c in enumerate(chrs)], pore, iopt
    )
    t_build = time.time() - t0
    print(f"# index: {index.n_seeds/1e6:.1f} M seeds in {t_build:.1f}s",
          file=sys.stderr)

    t0 = time.time()
    engine = MappingEngine(index, mopt)  # uploads the table to the device
    import jax

    jax.block_until_ready(engine.didx.keys) if engine.didx else None
    t_upload = time.time() - t0
    l, mc, e_cap, a_cap, p_cap = engine._plan(
        np.array([args.read_len * 9], dtype=np.int64)
    )
    print(f"# upload: {t_upload:.1f}s; mid_occ={mopt.mid_occ} "
          f"a_cap={a_cap} p_cap={p_cap}", file=sys.stderr)

    if args.chrs == 1:
        reads = simulate_reads(genome, pore, n_reads=args.reads,
                               read_len=args.read_len, rng=rng)
        read_chr = [0] * args.reads
    else:
        # spread reads across chromosomes (equal lengths -> uniform split)
        per = np.bincount(
            rng.integers(0, args.chrs, size=args.reads), minlength=args.chrs
        )
        reads, read_chr = [], []
        for ci, cnt in enumerate(per):
            if not cnt:
                continue
            rs = simulate_reads(chrs[ci], pore, n_reads=int(cnt),
                                read_len=args.read_len, rng=rng)
            rs = [(f"chr{ci+1}_{n}", s, st, sd) for n, s, st, sd in rs]
            reads.extend(rs)
            read_chr.extend([ci] * int(cnt))
    batch = [(n, s) for n, s, _, _ in reads]

    t0 = time.time()
    engine.warmup(args.batch)
    results = engine.map_batch(batch)
    t_warm = time.time() - t0
    print(f"# warmup + first batch: {t_warm:.1f}s", file=sys.stderr)

    best = float("inf")
    for i in range(args.passes):
        t0 = time.time()
        results = engine.map_batch(batch)
        dt = time.time() - t0
        print(f"# pass {i}: {dt:.2f}s", file=sys.stderr)
        best = min(best, dt)

    spb = mopt.sample_per_base
    bases = 0.0
    n_mapped = n_correct = 0
    for (name, sig, true_start, strand), ci_chr, res in zip(
        reads, read_chr, results
    ):
        rec = res.records[0]
        ci = 1
        for tag in rec.tags.split("\t"):
            if tag.startswith("ci:i:"):
                ci = int(tag[5:])
        bases += ci * mopt.chunk_size / spb
        if rec.mapped:
            n_mapped += 1
            if (rec.ref_id == ci_chr
                    and abs(rec.frag_start - true_start) < args.read_len + 500
                    and rec.rev == strand):
                n_correct += 1

    out = {
        "metric": f"large_genome_mapping_{args.mbp:g}mbp",
        "preset": args.preset + (f"_w{args.w}" if args.w else ""),
        "repeat_rich": args.repeat_rich,
        "bps": round(bases / best, 1),
        "reads_per_s": round(args.reads / best, 2),
        "mapped_frac": round(n_mapped / args.reads, 3),
        "accuracy": round(n_correct / max(n_mapped, 1), 3),
        "index_build_s": round(t_build, 1),
        "device_upload_s": round(t_upload, 1),
        "warmup_s": round(t_warm, 1),
        "a_cap": a_cap,
        "p_cap": p_cap,
        "mid_occ": int(mopt.mid_occ),
        "regrows": engine.stats.get("anchor_regrows", 0),
        "hit_overflow": engine.stats.get("hit_overflow", 0),
        "peak_rss_gb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024**2, 2
        ),
        "n_seeds": int(index.n_seeds),
        "hbm_table_bytes": int(
            index.n_seeds * 8 + index.keys.shape[0] * 8
        ),  # pos_id+pos_ps u32 pairs + keys u32 + offsets i32
        "stage_profile_s": {
            k: round(v, 2) for k, v in engine.profiler.totals.items()
        },
        "h2d_bytes": engine.stats.get("h2d_bytes", 0),
        "d2h_bytes": engine.stats.get("d2h_bytes", 0),
        "bytes_per_read": round(
            (engine.stats.get("h2d_bytes", 0)
             + engine.stats.get("d2h_bytes", 0))
            / max(engine.stats.get("reads", 1), 1)
        ),
    }
    if args.baseline_bps > 0:
        out["baseline_bps"] = args.baseline_bps
        out["vs_baseline"] = round(out["bps"] / args.baseline_bps, 4)

    if args.reference:
        import bench as _bench

        ref = _bench._reference_same_host_bps(
            genome, pore, reads, mopt, args.preset, timeout=3600
        )
        if ref:
            out["reference_same_host_bps"] = round(ref, 1)
            out["vs_reference_same_host"] = round(out["bps"] / ref, 3)
    return out


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
