"""Per-phase wall profile of the ecoli-scale (5 Mbp, sensitive) chunk cycle.

This script times every host-side phase of one batch's chunk loop
separately — chunk assembly, f16 cast, pack build, H2D bytes, dispatch
enqueue, scalar fetch, packed fetch, host chain tail — for the host-tail and
(optionally) device-tail engines, so the chunk cycle can be attributed
before optimizing.

Usage: python tools/profiling/ecoli_profile.py [--device-tail] [--genome-mbp N]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mbp", type=float, default=5.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--read-len", type=int, default=2500)
    ap.add_argument("--device-tail", action="store_true")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()

    import os

    if args.device_tail:
        os.environ["RAWHASH_TPU_DEVICE_TAIL"] = "1"

    from rawhash_tpu.config import IndexOptions, MapOptions, set_preset
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map import engine as eng_mod
    from rawhash_tpu.map.engine import MappingEngine, _BatchState
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(11)
    glen = int(args.genome_mbp * 1e6)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    pore = synthetic_pore(k=6)
    iopt = IndexOptions()
    mopt = MapOptions()
    set_preset("sensitive", iopt, mopt)
    mopt.batch_reads = args.batch
    mopt.max_anchors_per_read = 16384

    t0 = time.perf_counter()
    index = build_index_from_sequences([("chr1", genome)], pore, iopt)
    print(f"index: {index.n_seeds} seeds in {time.perf_counter()-t0:.1f}s")
    engine = MappingEngine(index, mopt)
    print(f"device_tail={engine.device_tail}")
    reads = simulate_reads(genome, pore, n_reads=args.batch,
                           read_len=args.read_len, rng=rng)
    batch = [(n, s) for n, s, _, _ in reads]

    t0 = time.perf_counter()
    engine.warmup(args.batch)
    print(f"warmup: {time.perf_counter()-t0:.1f}s")

    # instrument the chunk cycle by hand (mirrors _map_stream_impl without
    # the thread pool, so phases are sequential and attributable)
    for p in range(args.passes):
        st = _BatchState(engine, batch)
        print(f"pass {p}: l_chunk={st.l_chunk} e_cap={st.e_cap} "
              f"a_cap={st.a_cap} p_cap={st.p_cap} wide={st.wide} "
              f"key_words={engine._key_words}")
        t_pass = time.perf_counter()
        while not st.done():
            c = st.chunk_idx
            n_act = int(st.active.sum())
            t1 = time.perf_counter()
            eng_mod._submit_chunk(engine, st)
            t2 = time.perf_counter()
            if engine.device_tail:
                pack_bytes = 0
            else:
                pack = st.pending_inputs[1]
                pack_bytes = pack.nbytes
            eng_mod._process_chunk(engine, st)
            t3 = time.perf_counter()
            print(f"  chunk {c}: active={n_act} submit={t2-t1:.3f}s "
                  f"process={t3-t2:.3f}s pack_H2D={pack_bytes/1e6:.2f}MB "
                  f"n_prev_max={int(st.n_prev.max()) if not engine.device_tail else -1}")
        print(f"pass {p}: total {time.perf_counter()-t_pass:.2f}s, "
              f"active_end={int(st.active.sum())}")
        prof = {k: round(v, 2) for k, v in engine.profiler.totals.items()}
        print(f"profiler: {prof}")
        print(f"stats: { {k: v for k, v in engine.stats.items()} }")


if __name__ == "__main__":
    main()
