"""Streaming host pipeline: signal files -> batches -> device -> PAF.

The reference runs a 3-step kt_pipeline (bulk read -> parallel map -> ordered
output; reference: map_worker_pipeline, rmap.cpp:661-800).  Here the stages
are: a prefetch thread reads and batches signals, the main thread drives the
device engine batch-by-batch, and PAF records are emitted in input order.
Sequence Until taps the mapped stream between stages, exactly like the
reference's step-1b (rmap.cpp:708-734).
"""

from __future__ import annotations

import queue
import sys
import threading
import time

from ..config import IndexFlag, MapFlag


def _read_all(path):
    from ..io.sigfile import read_signals

    return list(read_signals(path))


def parallel_file_reads(files, n_threads: int):
    """Decode signal containers with a worker pool (the reference decodes
    under opt->n_io_threads; rsig.c:192-194, main.cpp:414).  Up to
    2*n_threads files are in flight; results are yielded strictly in file
    order so the stream is identical to a 1-thread run.

    Memory trade-off: each in-flight file is fully decoded into memory, so
    --io-thread changes residency from O(one batch) to O(2*n_threads x file
    size).  That suits the reference datasets' many-small-files layout
    (FAST5 dirs at ~4k reads/file); for a few huge BLOW5 files, prefer
    --io-thread 1 (streaming, O(batch) memory).  Unlike the reference's
    slow5_init_mt, parallelism here is across files, not within one file, so
    a single large file sees no decode speedup."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        inflight = collections.deque()
        it = iter(files)
        for f in it:
            inflight.append(ex.submit(_read_all, f))
            if len(inflight) >= 2 * n_threads:
                break
        while inflight:
            yield from inflight.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(ex.submit(_read_all, nxt))


def _batched_reads(paths, batch_size: int, mini_batch_bytes: int,
                   n_io_threads: int = 1):
    """Yield lists of (name, signal) with at most batch_size reads."""
    from ..io.sigfile import find_signal_files, read_signals

    files = [f for path in paths for f in find_signal_files(path)]
    if n_io_threads > 1 and len(files) > 1:
        reads_iter = parallel_file_reads(files, n_io_threads)
    else:
        reads_iter = (r for f in files for r in read_signals(f))
    batch = []
    for name, sig in reads_iter:
        batch.append((name, sig))
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def _prefetch(gen, q, stop):
    try:
        for item in gen:
            if stop.is_set():
                break
            q.put(item)
    finally:
        q.put(None)


def run_pipeline(args, iopt, mopt, t0: float) -> int:
    import numpy as np

    from ..index.build import (
        build_index_from_sequences,
        build_index_from_signals,
    )
    from ..index.serialize import is_index_file, load_index, save_index
    from ..io.fasta import read_fasta
    from ..pore import load_pore

    out = sys.stdout
    if args.output and args.output != "-":
        out = open(args.output, "w")
    log = lambda msg: print(f"[M::rawhash-tpu::{time.time()-t0:.3f}] {msg}",
                            file=sys.stderr)

    # --- out-quantize debug mode (reference: rindex.c:288-301) ---
    if iopt.flag & IndexFlag.OUT_QUANTIZE:
        _run_out_quantize(args, iopt, out)
        return 0

    # --- index: load or build (reference: ri_idx_reader_read) ---
    from ..index.ref_ind import is_ref_index, load_ref_index

    if is_index_file(args.target):
        index = load_index(args.target)
        log(f"loaded index: {index.n_seq} target(s), {index.n_seeds} seeds")
    elif is_ref_index(args.target):
        # the reference binary's own .ind format (rindex.c:650-776) loads
        # directly, so reference-built indexes drop into this engine
        index = load_ref_index(args.target)
        log(
            f"loaded reference .ind index: {index.n_seq} target(s), "
            f"{index.n_seeds} seeds"
        )
    else:
        if iopt.flag & IndexFlag.SIG_TARGET:
            from ..io.sigfile import find_signal_files

            files = find_signal_files(args.target)
            n_io = getattr(args, "io_thread", 1) or 1
            if n_io > 1 and len(files) > 1:
                reads = list(parallel_file_reads(files, n_io))
            else:
                reads = [r for f in files for r in _read_all(f)]
            pore = None
            if args.pore_file:
                pore = load_pore(args.pore_file, iopt.k, iopt.lev_col)
            index = build_index_from_signals(reads, pore, iopt)
        else:
            if not args.pore_file:
                print(
                    "[ERROR] a pore model (-p) is required to index a sequence file",
                    file=sys.stderr,
                )
                return 1
            pore = load_pore(args.pore_file, iopt.k, iopt.lev_col)
            index = build_index_from_sequences(
                read_fasta(args.target), pore, iopt
            )
        log(f"built index: {index.n_seq} target(s), {index.n_seeds} seeds")
        if args.dump_index:
            if args.dump_index.endswith(".ind"):
                # reference binary .ind interchange: the dumped artifact is
                # loadable by the reference rawhash2 binary (ri_idx_load,
                # rindex.c:650-776) with identical PAF output
                from ..index.ref_ind import dump_ref_index

                dump_ref_index(args.dump_index, index)
            else:
                save_index(args.dump_index, index)
            log(f"index dumped to {args.dump_index}")
    if not args.query:
        if not args.dump_index and not is_index_file(args.target):
            log("no query files; only the index was constructed")
        return 0

    # --- mapping ---
    from .engine import MappingEngine
    from .sequence_until import SequenceUntil
    from ..io.paf import paf_lines

    engine = MappingEngine(index, mopt)
    log(f"mid_occ = {mopt.mid_occ}")
    # pre-compile the chunk-step program while the prefetch thread below
    # reads/decodes signal files: the multi-minute XLA warmup then overlaps
    # I/O instead of stalling the first mapped read
    engine.warmup_async()
    su = None
    if mopt.flag & MapFlag.SEQUENCEUNTIL:
        su = SequenceUntil(
            index.n_seq, mopt.t_threshold, mopt.tn_samples,
            mopt.ttest_freq, mopt.tmin_reads,
        )

    batch_size = mopt.batch_reads
    gen = _batched_reads(args.query, batch_size, mopt.mini_batch_size,
                         getattr(args, "io_thread", 1) or 1)
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    th = threading.Thread(target=_prefetch, args=(gen, q, stop), daemon=True)
    th.start()

    import collections

    pending_batches: collections.deque = collections.deque()

    def batch_iter():
        while True:
            item = q.get()
            if item is None:
                return
            pending_batches.append(item)
            yield item

    n_reads = n_mapped = 0
    total_samples = 0
    try:
        # map_stream keeps two batches in flight (device/host overlap);
        # results come back in submission order, so FIFO pairing is exact
        for results in engine.map_stream(batch_iter()):
            batch = pending_batches.popleft()
            for (name, sig), res in zip(batch, results):
                total_samples += sig.shape[0]
                n_reads += 1
                for line in paf_lines(res, index):
                    out.write(line + "\n")
                mapped = [m for m in res.records if m.mapped]
                if mapped:
                    n_mapped += 1
                    if su is not None and su.observe(
                        mapped[0].ref_id, mapped[0].frag_len
                    ):
                        log(
                            "Sequence Until: estimates converged, stopping "
                            f"after {su.nreads} mapped reads"
                        )
                        stop.set()
                        raise StopIteration
            out.flush()
    except StopIteration:
        pass
    finally:
        stop.set()
        # drain the prefetch thread: it may be blocked in q.put on the full
        # queue; empty the queue so it observes `stop` and exits, then join
        # the warmup thread (see MappingEngine.finish_warmup — a daemon
        # thread inside a jax call at interpreter teardown SIGABRTs)
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=30.0)
        engine.finish_warmup()

    from ..utils.timers import resource_summary

    dt = time.time() - t0
    log(f"stage profile: {engine.profiler.summary()}")
    log(resource_summary(t0))
    log(
        f"mapped {n_mapped}/{n_reads} reads, {total_samples} samples in "
        f"{dt:.2f}s ({total_samples/max(dt,1e-9):.0f} samples/s); "
        f"{engine.stats.get('device_tail_chunks', 0)} chunks on the device tail"
    )
    if engine.stats["hit_overflow"] or engine.stats["prev_overflow"]:
        log(
            f"capacity overflows: {engine.stats['hit_overflow']} seed hits, "
            f"{engine.stats['prev_overflow']} carried anchors dropped "
            "(raise --max-anchors to eliminate)"
        )
    if out is not sys.stdout:
        out.close()
    return 0


def _run_out_quantize(args, iopt, out) -> None:
    """Print quantized event streams (reference: --out-quantize,
    rsketch.c:179,192 + worker_sig_pipeline)."""
    import numpy as np

    from ..io.sigfile import find_signal_files, read_signals
    from ..signal.events_host import detect_events_np, normalize_signal_np
    from ..sketch.host import diff_compact_indices
    from ..sketch.quantize import dynamic_quantize_np

    for path in [args.target] + list(args.query):
        for f in find_signal_files(path):
            for name, sig in read_signals(f):
                if iopt.flag & IndexFlag.NO_EVENT_DETECTION:
                    events, _ = normalize_signal_np(sig, (0.0, 0.0, 0))
                else:
                    events, _ = detect_events_np(
                        sig, (0.0, 0.0, 0),
                        iopt.window_length1, iopt.window_length2,
                        iopt.threshold1, iopt.threshold2, iopt.peak_height,
                    )
                kept = diff_compact_indices(events, iopt.diff)
                codes = dynamic_quantize_np(
                    events[kept], iopt.fine_min, iopt.fine_max,
                    iopt.fine_range, 1 << iopt.q,
                ) & ((1 << iopt.q) - 1)
                out.write(name + "\n")
                out.write(",".join(str(int(c)) for c in codes) + "\n")
