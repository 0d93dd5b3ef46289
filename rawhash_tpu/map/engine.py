"""Real-time mapping engine: batch chunk loop + decision logic + PAF records.

Host orchestrator around the fused device chunk step (map/device_step.py).
Per batch of reads it keeps the per-read carry state (normalization sums,
event offset, carried chain anchors), invokes one XLA program per chunk, and
runs the tiny sequential tail per read on the host: chain backtracking,
region/primary/MAPQ logic and the mapping decision
(reference: map_worker_for, rmap.cpp:389-599).

Reads exit the loop as soon as a decision fires (adaptive sampling /
Read Until), exactly like the reference's per-chunk break."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from ..chain.host import chain_backtrack, compact_chains
from ..chain.regions import gen_regs, select_sub, set_mapq, set_parent, wang_hash32
from ..config import IndexFlag, MapFlag, MapOptions
from ..index.build import RawIndex, update_mid_occ
from ..index.device import DeviceIndex
from ..signal.events import NormCarry
from .device_step import chunk_step

RI_ID_SHIFT = 32


def _pow2_up(x: int) -> int:
    """Smallest power of two >= x (capacity-ladder snap)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass
class MapRecord:
    """One output mapping (reference: ri_map_t, rmap.h)."""

    read_length: int = 0
    ref_id: int = 0
    read_start: int = 0
    read_end: int = 0
    frag_start: int = 0
    frag_len: int = 0
    mapq: int = 0
    rev: int = 0
    mapped: int = 0
    tags: str = ""


@dataclasses.dataclass
class ReadResult:
    name: str
    records: list  # list[MapRecord]


def _pack_xy(key: np.ndarray, tpos: np.ndarray, qpos: np.ndarray, span: int):
    """Planes -> reference 128-bit anchor packing for the host-side chain
    tail (x = rev<<63|tid<<32|tpos, y = span<<32|qpos)."""
    key = key.astype(np.uint64)
    rev = key >> np.uint64(31)
    tid = key & np.uint64(0x7FFFFFFF)
    ax = (rev << np.uint64(63)) | (tid << np.uint64(32)) | tpos.astype(np.uint64)
    ay = (np.uint64(span) << np.uint64(32)) | qpos.astype(np.uint64)
    return ax, ay


def _unpack_xy(ax: np.ndarray, ay: np.ndarray):
    rev = (ax >> np.uint64(63)).astype(np.uint32)
    tid = ((ax >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.uint32)
    key = (rev << np.uint32(31)) | tid
    tpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    qpos = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return key, tpos, qpos


class MappingEngine:
    def __init__(self, index: RawIndex, mopt: MapOptions, device=None):
        import jax.numpy as jnp

        from ..utils.xla_cache import enable_compile_cache

        enable_compile_cache()
        # half-precision signal transfer halves host->device bytes; the
        # device casts back to f32 (pA in (30,200): f16 error ~0.06 pA,
        # far below pore noise)
        self.signal_dtype = np.float16
        from ..utils.timers import StageProfiler

        self.profiler = StageProfiler()

        self.index = index
        self.iopt = index.opts
        self.mopt = mopt
        update_mid_occ(mopt, index)
        # multi-chip mode: table hash-range-sharded over `shard`, batch over
        # all devices; the single-device path keeps the prefix-table index
        if getattr(mopt, "n_shards", 0) >= 1:
            from ..parallel.dist import DistContext, make_mesh

            self.dist = DistContext(index, make_mesh(None, mopt.n_shards))
            self.didx = None
        else:
            self.dist = None
            self.didx = DeviceIndex.from_host(index, device)
        self.span = self.iopt.k + self.iopt.e - 1
        # chain penalties (reference: rmap.cpp:318)
        self.chn_pen_gap = float(
            np.float32(mopt.chain_gap_scale) * np.float32(0.01) * np.float32(self.span)
        )
        self.chn_pen_skip = float(
            np.float32(mopt.chain_skip_scale) * np.float32(0.01) * np.float32(self.span)
        )
        # all-vs-all name-rank table (reference compares names with strcmp,
        # rmap.cpp:86; ranks in sorted-name order give the same predicate)
        order = sorted(range(index.n_seq), key=lambda i: index.seq_names[i])
        ranks = np.zeros(index.n_seq, dtype=np.int32)
        for r, i in enumerate(order):
            ranks[i] = r
        self._target_rank = jnp.asarray(ranks if index.n_seq else np.zeros(1, np.int32))
        self._sorted_names = [index.seq_names[i] for i in order]
        self._jnp = jnp
        self.stats = {"hit_overflow": 0, "prev_overflow": 0, "reads": 0, "mapped": 0}
        import threading

        self._stats_lock = threading.Lock()  # _process_chunk runs in workers
        # cooperative warmup cancellation: the CLI joins the warmup thread
        # before interpreter exit (a live daemon thread inside a jax call at
        # teardown SIGABRTs with "FATAL: exception not rethrown"); setting
        # this event lets warmup skip any dispatch it has not yet started so
        # the join returns quickly on short runs
        self._warmup_stop = threading.Event()
        self._warmup_thread = None
        # D2H anchor packing width: (rev, tid, tpos) ride 1 i16 word for
        # small genomes, 2 for anything up to 2^31 combined bits, else the
        # full 4-word split (fewer bytes per fetched anchor)
        max_len = int(max(index.seq_lens)) if index.n_seq else 1
        tid_bits = max(1, (max(index.n_seq, 1) - 1).bit_length()) if index.n_seq > 1 else 0
        self._pos_bits = max(1, max_len.bit_length())
        total_bits = 1 + tid_bits + self._pos_bits
        if total_bits <= 16:
            self._key_words = 1
        elif total_bits <= 32:
            self._key_words = 2
        else:
            self._key_words = 4
        self._tid_bits = tid_bits
        # speculative D2H prefix widths (learned from the previous chunk's
        # live widths; 0 = first chunk, exact fetch): packed anchors for the
        # host tail, chain-summary rows for the device tail
        self._spec_ncut = 0
        self._spec_kcut = 0
        self._spec_ftot = 0  # flat packed-anchor total (pow2 ladder)
        self._occ_cache = None  # position-weighted occupancy (mu, sigma)
        # observed per-chunk anchor watermark (hits + overflow), fed back
        # into _plan: the static occupancy model misestimates grossly at
        # scale, and a budget-clamped a_cap below the true need made EVERY
        # chunk quarantine-redispatch the whole batch.  Observation beats
        # the model from the first chunk on.
        self._learned_need = 0
        # device-tail capacity feedback: the tail's growth loop re-runs the
        # WHOLE batch per grown capacity, and (k_cap, p_cap) reset per batch
        # made every pass pay 2-3 full re-dispatches; converged values carry
        # across batches here
        self._learned_kcap = 0
        self._learned_fk = 0  # flat chain-summary capacity (device tail)
        self._learned_fp = 0  # flat packed-anchor capacity (host tail)
        self._learned_pcap = 0
        # device-tail mode: backtrack + compaction run on-device and only
        # per-chain summaries leave the device (O(chains) D2H instead of
        # O(anchors)); carried anchors stay device-resident.  At small
        # anchor widths the host tail's fetch is small, while at wide ones
        # (671 MB/chunk of anchors at 100 Mbp sensitive) it dominates.
        # Selection is therefore OBSERVATION-driven: engines start host-tail
        # and auto-switch when the learned per-chunk anchor watermark
        # crosses the threshold (static occupancy estimates overestimate
        # grossly when query seeds miss the table, e.g. fast-preset 1 Gbp).
        # Batches bind their mode at creation (st.tail), so in-flight
        # batches finish consistently.  RAWHASH_TPU_DEVICE_TAIL=1 forces on,
        # RAWHASH_TPU_NO_DEVICE_TAIL=1 forces off.  Host-tail remains
        # required for modes needing per-anchor host data (RMQ re-chaining,
        # --bw-long, DTW evaluation); the sharded engine runs the tail
        # inside its shard_map (parallel/dist.py::_build_dist_step_tail).
        import os as _os

        self._tail_eligible = (
            not (mopt.flag & MapFlag.DTW_EVALUATE_CHAINS)
            and not (mopt.flag & MapFlag.RMQ)
            and mopt.bw_long <= mopt.bw
            and not _os.environ.get("RAWHASH_TPU_NO_DEVICE_TAIL")
        )
        self.device_tail = self._tail_eligible and bool(
            _os.environ.get("RAWHASH_TPU_DEVICE_TAIL")
        )
        self._tail_auto = self._tail_eligible and not self.device_tail
        # Auto-switch threshold: the host tail's real cost is its packed
        # D2H (B x pow2(watermark) x bytes/anchor), so the watermark
        # threshold derives from a BYTE budget.  The 8 MB per-chunk budget
        # puts ecoli widths (~21 MB/chunk) on the device tail and viral
        # widths (~2.6 MB/chunk) on the host tail; the default is not yet
        # measured on the H100 over PCIe.
        # RAWHASH_TPU_TAIL_SWITCH_ANCHORS still overrides directly.
        bpa = 2 * (self._key_words + 3)  # i16 words; wide batches cost 2x
        budget = int(
            _os.environ.get("RAWHASH_TPU_TAIL_SWITCH_BYTES", str(8 << 20))
        )
        anchors_env = _os.environ.get("RAWHASH_TPU_TAIL_SWITCH_ANCHORS")
        self.tail_switch_anchors = (
            int(anchors_env)
            if anchors_env
            else max(512, budget // (bpa * max(1, mopt.batch_reads)))
        )
        # host-tail flat exact-count packed fetch: OPT-IN.  The dense
        # path's speculative prefix + straggler row-gather is already
        # byte-tight at viral widths, and the widths where dense fetches
        # explode auto-switch to the device tail's flat summaries instead.
        # Off by default; not yet measured on the H100.  The dist program
        # keeps the dense layout either way (its batch rows are sharded,
        # a global flat offset space is not).
        self._flat_pack = self.dist is None and bool(
            _os.environ.get("RAWHASH_TPU_FLAT_PACK")
        )

    # ---------- helpers ----------

    def _q_rank(self, name: str) -> int:
        """Rank r such that (target_rank > r) <=> target name > query name
        (strcmp semantics of the reference's all-vs-all skip, rmap.cpp:86)."""
        import bisect

        return bisect.bisect_right(self._sorted_names, name) - 1

    def _decide(self, regs, is_dtw: bool):
        """Mapping decision for one read after a chunk
        (reference: rmap.cpp:423-500). Returns (map_chain_ids, done)."""
        mo = self.mopt
        n_cregs = len(regs)
        all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
        if n_cregs == 1 and (
            regs[0].mapq >= mo.min_mapq
            or (is_dtw and regs[0].alignment_score >= mo.dtw_min_score)
        ):
            return [0], True
        n_chains = n_cregs if (all_chains or n_cregs < 1) else 1
        mean_c = mean_q = 0.0
        if n_cregs > 0:
            mean_c = sum(r.score for r in regs) / n_cregs
            mean_q = sum(r.mapq for r in regs) / n_cregs
        maps = []
        ic = 0
        while ic < n_chains:
            best_q = float(regs[ic].mapq)
            best_c = float(regs[ic].score)
            weighted = 0.0
            if not all_chains:
                if is_dtw:
                    best_a = regs[ic].alignment_score
                    if n_chains == 1:
                        best_ind = 0
                        for i2 in range(1, n_cregs):
                            if regs[i2].alignment_score > best_a:
                                best_a = regs[i2].alignment_score
                                best_ind = i2
                        ic = best_ind
                        best_q = float(regs[ic].mapq)
                        best_c = float(regs[ic].score)
                    if best_a >= mo.dtw_min_score:
                        r_bestma = max(best_a / 50.0, 0.0) if best_a > 0 else 0.0
                        r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
                        r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
                        weighted = (
                            mo.w_bestma * r_bestma
                            + mo.w_bestmq * r_bestmq
                            + mo.w_bestmc * r_bestmc
                        )
                else:
                    r_bestq = min(best_q / 30.0, 1.0) if best_q > 0 else 0.0
                    r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
                    r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
                    weighted = (
                        mo.w_bestq * r_bestq
                        + mo.w_bestmq * r_bestmq
                        + mo.w_bestmc * r_bestmc
                    )
            if weighted >= mo.w_threshold or (
                all_chains and regs[ic].score >= mo.min_chaining_score2
            ):
                maps.append(ic)
            ic += 1
        return maps, len(maps) > 0

    def _chunk_tail(self, key, tpos, qpos, n_anchors, f, p, ev_total):
        """Host tail of one chunk for one read: backtrack -> regions -> MAPQ.
        Returns (regs, chain_axy, prev_planes)."""
        mo = self.mopt
        n = int(n_anchors)
        ax, ay = _pack_xy(key[:n], tpos[:n], qpos[:n], self.span)
        if mo.flag & MapFlag.RMQ:
            # RMQ chaining mode: refill scores with the host RMQ chainer
            # (reference: rmap.cpp:332-334); the device DP fill is unused
            from ..chain.rmq import lchain_rmq_np

            max_gap = max(mo.max_target_gap_length, mo.max_query_gap_length)
            u_s, bx, by, px, py = lchain_rmq_np(
                ax, ay, max_gap, mo.rmq_inner_dist, mo.bw, mo.max_num_skips,
                mo.rmq_size_cap, mo.min_num_anchors, mo.min_chaining_score,
                self.chn_pen_gap, self.chn_pen_skip,
            )
        else:
            from .._native import chain_tail_native

            native = chain_tail_native(
                f[:n], p[:n], ax, ay,
                mo.min_num_anchors, mo.min_chaining_score, mo.bw,
            )
            if native is not None:
                u_s, bx, by, px, py = native
            else:
                u, v = chain_backtrack(
                    f[:n].astype(np.int32),
                    p[:n].astype(np.int64),
                    min_cnt=mo.min_num_anchors,
                    min_sc=mo.min_chaining_score,
                    max_drop=mo.bw,
                )
                u_s, bx, by, px, py = compact_chains(u, v, ax, ay)
        if mo.bw_long > mo.bw and bx.shape[0] > 0:
            # long-gap re-chaining pass (reference: rmap.cpp:336-340)
            from ..chain.rmq import lchain_rmq_np

            max_gap = max(mo.max_target_gap_length, mo.max_query_gap_length)
            u_s, bx, by, px, py = lchain_rmq_np(
                bx, by, max_gap, mo.rmq_inner_dist, mo.bw_long,
                mo.max_num_skips, mo.rmq_size_cap, mo.min_num_anchors,
                mo.min_chaining_score, self.chn_pen_gap, self.chn_pen_skip,
            )
        # read hash (reference: rmap.cpp:346-348)
        h = 0
        h ^= (wang_hash32(ev_total) + wang_hash32(11)) & 0xFFFFFFFF
        h = wang_hash32(h)
        all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
        from .._native import gen_regions_native

        regs = gen_regions_native(
            h, u_s, bx, by,
            mo.mask_level, mo.mask_len,
            bool(mo.flag & MapFlag.HARD_MLEVEL), mo.alt_drop,
            not all_chains, mo.pri_ratio, mo.best_n, True,
            int(mo.max_target_gap_length * 0.8),
        )
        if regs is None:  # no native toolchain: python oracle path
            regs = gen_regs(h, u_s.shape[0], u_s, bx, by)
            set_parent(
                regs, mo.mask_level, mo.mask_len,
                bool(mo.flag & MapFlag.HARD_MLEVEL), mo.alt_drop,
            )
            if not all_chains:
                regs = select_sub(
                    regs, mo.pri_ratio, mo.best_n, True,
                    int(mo.max_target_gap_length * 0.8),
                )
        return regs, (bx, by), (px, py)

    # ---------- batched chunk-loop state machine ----------

    def _occ_stats(self):
        """Position-weighted occupancy statistics of the filtered index.

        A query seed drawn from the genome hits key k with probability
        proportional to count(k); keys with count > mid_occ are filtered to
        zero hits (rseed.c:105-133).  So expected hits per seed is the
        position-weighted mean mu = sum(c_k^2 | c_k<=mid) / sum(c_k), and the
        per-chunk hit total over ~e_cap seeds concentrates around
        e_cap*mu +/- sqrt(e_cap)*sigma.  Sizing from (mu, sigma) instead of
        the key-mean keeps repeat-rich genomes from overflowing (the
        reference never truncates: rh_kvec growth, rseed.c:105-154)."""
        if self._occ_cache is None:
            counts = self.index.counts().astype(np.float64)
            tot = counts.sum()
            if tot <= 0:
                self._occ_cache = (1.0, 0.0)
            else:
                surv = counts[counts <= self.mopt.mid_occ]
                mu = float((surv**2).sum() / tot)
                ex2 = float((surv**3).sum() / tot)
                sigma = float(np.sqrt(max(ex2 - mu * mu, 0.0)))
                self._occ_cache = (mu, sigma)
        return self._occ_cache

    def _plan(self, qlens: np.ndarray):
        """Static capacities for a batch (NO_ADAPTIVE maps the whole read in
        one chunk, reference: rmap.cpp:403-404).  These are the *initial*
        capacities: the chunk loop grows a_cap/p_cap (and escalates to the
        wide i32 packing) whenever a chunk overflows, so no hit is ever
        silently dropped (reference semantics: rh_kvec never truncates).

        Capacities snap to powers of two: every distinct (shape, statics)
        signature is a separate XLA compile (minutes on this backend), so
        a tiny capacity ladder keeps different genomes / occupancy profiles
        reusing the same compiled programs and the same persistent-cache
        entries instead of each picking a bespoke multiple of 128."""
        mo = self.mopt
        if mo.flag & MapFlag.NO_ADAPTIVE:
            l_chunk = int(max(1, qlens.max()))
            l_chunk = ((l_chunk + 4095) // 4096) * 4096
            max_chunk = 1
            e_cap = max(256, min(_pow2_up(l_chunk // 3), 1 << 14))
            mu, sigma = self._occ_stats()
            expected = int(e_cap * mu + 4.0 * np.sqrt(e_cap) * sigma)
            a_cap = max(mo.max_anchors_per_read, expected, 512)
            a_cap = min(_pow2_up(a_cap), int(mo.max_anchor_cap) or 32000)
            p_cap = 8  # single chunk: carried anchors unused
        else:
            l_chunk = int(mo.chunk_size)
            max_chunk = int(mo.max_num_chunk)
            e_cap = mo.max_events_per_chunk
            # expected hits/chunk = seeds/chunk x position-weighted mean
            # occupancy, + 4 sigma of the sum for repeat-tail headroom.
            # Once any chunk has actually run, the OBSERVED watermark
            # (n_anchors + overflow, tracked in _process_chunk) replaces the
            # model with 25% headroom: the model overestimates grossly at
            # 100 Mbp scale, and an undersized a_cap makes every chunk pay a
            # whole-batch quarantine re-dispatch
            learned = self._learned_need
            total = mo.max_anchors_per_read
            if learned > 0:
                # pow2 snap already grants 0-100% headroom over the p95
                # watermark; residual outliers go through the quarantine
                a_cap = _pow2_up(max(512, learned))
            else:
                mu, sigma = self._occ_stats()
                expected = int(e_cap * mu + 4.0 * np.sqrt(e_cap) * sigma)
                a_cap = min(_pow2_up(max(512, expected)), _pow2_up(total) // 2)
            a_cap = min(a_cap, int(mo.max_anchor_cap) or 32000)
            # total is a BUDGET, not a target: the initial carried-anchor
            # width starts at <= 4x the per-chunk hit capacity (carried
            # anchors are only the chained survivors of earlier chunks) and
            # grows on demand — a large --max-anchors budget must not
            # inflate every chunk's sort/fill width up front
            # floor 64: when a learned a_cap meets or exceeds the budget the
            # subtraction collapses, but carried anchors still need room
            # (grow_prev covers the data-driven rest)
            p_cap = _pow2_up(max(min(total - a_cap, 4 * a_cap), 64))
        return l_chunk, max_chunk, e_cap, a_cap, p_cap

    def warmup(self, batch_size: int | None = None) -> float:
        """Pre-compile the chunk-step program for the planned capacities by
        dispatching one dummy batch (noise signals at chunk_size).  Returns
        the wall seconds spent.  Called by the CLI in a background thread at
        index-load time so the multi-minute XLA compile overlaps file
        discovery/decode instead of stalling the first mapped read
        (real-time premise: the reference maps its first read instantly).

        Only the adaptive chunked mode has statically known shapes;
        NO_ADAPTIVE (ava) shapes depend on the incoming read lengths, so
        warmup is a no-op there."""
        if self.mopt.flag & MapFlag.NO_ADAPTIVE:
            return 0.0
        import os as _os

        import jax as _jax

        # CPU compiles in seconds; spending a dummy-batch execution there
        # (tests, small hosts) buys nothing
        if _jax.default_backend() == "cpu" and not _os.environ.get(
            "RAWHASH_TPU_FORCE_WARMUP"
        ):
            return 0.0
        t0 = time.perf_counter()
        b = int(batch_size or self.mopt.batch_reads)
        rng = np.random.default_rng(0)
        reads = [
            (f"__warmup_{i}",
             rng.normal(90.0, 10.0, self.mopt.chunk_size).astype(np.float32))
            for i in range(b)
        ]
        if self._warmup_stop.is_set():
            return 0.0
        st = _BatchState(self, reads)
        # dummy dispatches bill their stage time to "warmup:*", so compile
        # time does not masquerade as steady-state submit cost
        st.stage_prefix = "warmup:"

        def _cells_of(pending_inputs) -> int:
            # exact per-dispatch accounting: mirror _dispatch_step's formula
            # from the pack that was actually uploaded (the p_use ladder and
            # dist mode change the width)
            pack = pending_inputs[1]
            width = st.a_cap + max((pack.shape[1] - 2) // 3, 0)
            return st.b_dev * width * self.mopt.max_chain_iter

        _submit_chunk(self, st)  # the p_use=8 program (chunk 1 AND any
        # later chunk whose carried-anchor width stays on the first ladder
        # step — one signature covers both since the empty-pack special
        # case was retired)
        out = st.pending
        np.asarray(out.scalars)  # blocks until the program is compiled + run
        if st.tail:
            # _dispatch_step_tail always accounts a_cap + p_cap
            dummy_cells = st.b_dev * (st.a_cap + st.p_cap) * self.mopt.max_chain_iter
            np.asarray(
                out.summ_flat[:64]
                if out.summ_flat is not None
                else out.summaries[:, :64, :]
            )
        else:
            dummy_cells = _cells_of(st.pending_inputs)
            # the packed-anchor slice fetch compiles its own small program
            np.asarray(
                out.packed_flat[:256]
                if out.packed_flat is not None
                else out.packed[:, : min(256, out.packed.shape[1]), :]
            )
        # undo the work-accounting of the dummy dispatches (exact amounts, so
        # a warmup racing real batches does not erase their counts)
        with self._stats_lock:
            self.stats["dp_cells"] = self.stats.get("dp_cells", 0) - dummy_cells
        dt = time.perf_counter() - t0
        self.stats["warmup_s"] = round(dt, 2)
        return dt

    def warmup_async(self, batch_size: int | None = None):
        """Kick off warmup() in a daemon thread; returns the thread, or None
        when warmup would be a no-op (don't start a thread that races jax
        state at interpreter shutdown — observed as SIGABRT "exception not
        rethrown" teardown crashes in short CLI runs)."""
        import os as _os
        import threading

        import jax as _jax

        if self.mopt.flag & MapFlag.NO_ADAPTIVE:
            return None
        if _jax.default_backend() == "cpu" and not _os.environ.get(
            "RAWHASH_TPU_FORCE_WARMUP"
        ):
            return None
        th = threading.Thread(
            target=lambda: self.warmup(batch_size), daemon=True
        )
        th.start()
        self._warmup_thread = th
        return th

    def finish_warmup(self, timeout: float | None = None) -> None:
        """Cancel any not-yet-started warmup dispatches and join the warmup
        thread.  MUST run before interpreter exit whenever warmup_async was
        used: a daemon thread blocked inside a jax call at teardown dies with
        SIGABRT ("terminate called ... FATAL: exception not rethrown"),
        turning a successful mapping run into a nonzero exit."""
        self._warmup_stop.set()
        th = self._warmup_thread
        if th is not None and th.is_alive():
            th.join(timeout)
        self._warmup_thread = None


class _BatchState:
    """All per-batch mapping state across the chunk loop."""

    def __init__(self, engine: "MappingEngine", reads: list):
        import jax.numpy as jnp

        self.reads = reads
        self.b = len(reads)
        self.names = [n for n, _ in reads]
        self.sigs = [np.asarray(s, dtype=np.float32) for _, s in reads]
        self.qlens = np.array([s.shape[0] for s in self.sigs], dtype=np.int64)
        (self.l_chunk, self.max_chunk, self.e_cap, self.a_cap,
         self.p_cap) = engine._plan(self.qlens)
        b, p_cap = self.b, self.p_cap
        # device-side arrays pad the batch to a power of two (and to the
        # mesh size in dist mode): padded rows have slen 0 and never produce
        # anchors, and snapping the batch dim means a stream's final partial
        # batch reuses an already-compiled signature instead of paying a
        # fresh multi-minute XLA compile for its bespoke size
        b_snap = _pow2_up(b)
        self.b_dev = engine.dist.pad_batch(b_snap) if engine.dist else b_snap
        self.carry = NormCarry.zeros(self.b_dev)
        self.ev_offset = jnp.zeros(self.b_dev, jnp.int32)
        self.prev_key = np.full((b, p_cap), 0xFFFFFFFF, dtype=np.uint32)
        self.prev_tpos = np.zeros((b, p_cap), dtype=np.int32)
        self.prev_qpos = np.zeros((b, p_cap), dtype=np.int32)
        self.n_prev = np.zeros(b, dtype=np.int32)
        # uploaded once per batch, reused across chunks (device-resident)
        ranks = np.zeros(self.b_dev, dtype=np.int32)
        ranks[:b] = [engine._q_rank(n) for n in self.names]
        self.q_rank_dev = jnp.asarray(ranks)
        self.active = np.ones(b, dtype=bool)
        self.last_regs = [[] for _ in range(b)]
        self.c_counts = np.zeros(b, dtype=np.int64)
        self.map_ids = [None] * b
        self.ev_totals = np.zeros(b, dtype=np.int64)
        self.t_start = np.full(b, time.perf_counter())
        self.t_decided = np.zeros(b, dtype=np.float64)
        self.all_events = [[] for _ in range(b)]
        self.chunk_idx = 0
        self.stage_prefix = ""  # "warmup:" for dummy batches
        # dispatch frame: late chunks with few live reads re-dispatch a
        # compacted row subset (see _maybe_compact_frame).  frame[j] = host
        # row of dispatch row j; disp_b = current dispatch width
        self.frame = None
        self.disp_b = self.b_dev
        self.pending = None  # in-flight ChunkOut
        self.pending_slen = None
        self.pending_spec = None  # speculative packed-prefix (async D2H)
        self.pending_inputs = None  # (sig_dev, pack) kept for overflow retry
        self.pending_rows = None  # straggler row-slice (None = full frame)
        self.pending_rows_pad = None
        # mode binds at batch creation so an engine-level auto-switch never
        # changes an in-flight batch's semantics
        self.tail = engine.device_tail
        # device-tail state: carried anchors live on device between chunks
        self.prev_dev = None  # (key u32, tpos i32, qpos i32, n_prev i32)
        # per-read chain-summary capacity (grows on overflow; engine-level
        # feedback seeds it at the previously converged width)
        self.k_cap = max(64, engine._learned_kcap)
        # flat live-chain summary capacity: the tail fetches O(live chains)
        # bytes instead of the dense [B, k_cap, 10] buffer (185 MB/chunk at
        # D4 widths).  Pow2 ladder, learned across batches, grown on
        # flat_overflow exactly like the other capacities
        import os as _os

        _fk_base = int(_os.environ.get("RAWHASH_TPU_FK_BASE", "0"))
        self.fk_cap = _fk_base or max(
            engine._learned_fk,
            1 << int(np.ceil(np.log2(max(64, 16 * self.disp_b)))),
        )
        # flat packed-anchor capacity (host tail): exact-count D2H instead
        # of B x pow2(max row width); learned, grown on pack_overflow
        _fp_base = int(_os.environ.get("RAWHASH_TPU_FP_BASE", "0"))
        self.fp_cap = _fp_base or max(
            engine._learned_fp,
            1 << int(np.ceil(np.log2(max(1024, 32 * self.disp_b)))),
        )
        if self.tail and engine._learned_pcap > self.p_cap:
            self.p_cap = engine._learned_pcap
        # wide i32 packing whenever anchor indices or event offsets can
        # exceed the int16 range (the narrow layout halves D2H bytes)
        self.wide = (self.a_cap + self.p_cap >= (1 << 15)) or (
            self.e_cap * self.max_chunk >= 32700
        )

    def done(self) -> bool:
        return self.chunk_idx >= self.max_chunk or not self.active.any()

    def grow_prev(self, need: int, cap_ceil: int) -> None:
        """Widen the carried-anchor buffers to hold `need` chain anchors
        (the reference carries every chain anchor into the next chunk,
        rmap.cpp:111-116 — truncation would change chains)."""
        new_p = 1 << max(int(np.ceil(np.log2(max(need, 8)))), 3)
        new_p = min(new_p, cap_ceil)
        if new_p <= self.p_cap:
            return
        b = self.b
        pk = np.full((b, new_p), 0xFFFFFFFF, dtype=np.uint32)
        pt = np.zeros((b, new_p), dtype=np.int32)
        pq = np.zeros((b, new_p), dtype=np.int32)
        pk[:, : self.p_cap] = self.prev_key
        pt[:, : self.p_cap] = self.prev_tpos
        pq[:, : self.p_cap] = self.prev_qpos
        self.prev_key, self.prev_tpos, self.prev_qpos = pk, pt, pq
        self.p_cap = new_p
        self.wide = self.wide or (self.a_cap + self.p_cap >= (1 << 15))


def _maybe_compact_frame(engine: MappingEngine, st: _BatchState) -> None:
    """Shrink the dispatch frame to the live reads (host-tail single-device
    path).  At 100 Mbp widths a full-batch dispatch runs the whole batch's
    sort/fill plus a 25 MB carried-anchor upload to serve ONE straggler
    read; compacting to a {64,128,...}-row frame scales every per-chunk cost
    with live reads.  The engine-side device state (norm carry, ev_offset,
    q_rank) is gathered once per re-frame; host per-read state keeps
    original indexing via frame[j] -> host row."""
    import os as _os

    if (
        engine.dist is not None
        or st.chunk_idx == 0
        or (engine.mopt.flag & MapFlag.DTW_EVALUATE_CHAINS)
    ):
        return
    rows = np.nonzero(st.active)[0]
    if rows.size == 0:
        return
    base = int(_os.environ.get("RAWHASH_TPU_ROW_LADDER_BASE", "64"))
    f_pad = base
    while f_pad < rows.size:
        f_pad *= 2
    if f_pad >= st.disp_b:
        return
    import jax.numpy as jnp

    if st.frame is None:
        dev_rows = rows  # dispatch rows == host rows before any framing
    else:
        pos = np.full(st.b, -1, dtype=np.int64)
        pos[st.frame] = np.arange(st.frame.shape[0])
        dev_rows = pos[rows]
        assert (dev_rows >= 0).all()
    idx = np.zeros(f_pad, dtype=np.int32)
    idx[: rows.size] = dev_rows
    idx_d = jnp.asarray(idx)
    st.carry = NormCarry(
        st.carry.sum[idx_d], st.carry.sum_sq[idx_d], st.carry.n[idx_d]
    )
    st.ev_offset = st.ev_offset[idx_d]
    st.q_rank_dev = st.q_rank_dev[idx_d]
    if st.prev_dev is not None:
        # device-tail: carried anchors are device-resident; gather their rows
        pk, pt, pq, npv = st.prev_dev
        st.prev_dev = (pk[idx_d], pt[idx_d], pq[idx_d], npv[idx_d])
    st.frame = rows
    st.disp_b = f_pad


def _dispatch_step(engine: MappingEngine, st: _BatchState, sig_dev, pack,
                   *, a_cap=None, wide=None, carry=None, ev_offset=None,
                   q_rank=None, flat_cap=None):
    """Invoke the (single-device or sharded) chunk step with the batch's
    CURRENT capacities/packing.  The keyword overrides let the overflow
    quarantine re-dispatch a row SUBSET at a grown capacity (the sliced
    sig/pack/carry rows) without touching the main batch's program."""
    import jax.numpy as jnp

    mo = engine.mopt
    io = engine.iopt
    a_cap = st.a_cap if a_cap is None else a_cap
    wide = st.wide if wide is None else wide
    carry = st.carry if carry is None else carry
    ev_offset = st.ev_offset if ev_offset is None else ev_offset
    q_rank = st.q_rank_dev if q_rank is None else q_rank
    params = dict(
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max,
        fine_range=io.fine_range,
        window_length1=mo.window_length1,
        window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height,
        e_cap=st.e_cap, a_cap=a_cap,
        min_events=mo.min_events, mid_occ=int(mo.mid_occ),
        max_dist_t=mo.max_target_gap_length,
        max_dist_q=mo.max_query_gap_length,
        bw=mo.bw, max_iter=mo.max_chain_iter,
        chn_pen_gap=engine.chn_pen_gap, chn_pen_skip=engine.chn_pen_skip,
        all_vs_all=bool(mo.flag & MapFlag.ALL_CHAINS),
        keep_events=bool(mo.flag & MapFlag.DTW_EVALUATE_CHAINS),
        key_words=engine._key_words, pos_bits=engine._pos_bits,
        wide=wide,
        flat_cap=(
            flat_cap
            if flat_cap is not None
            else (st.fp_cap if engine._flat_pack else 0)
        ),
    )
    # chaining-DP work accounting for the bench's cell-updates/s metric:
    # the fill kernel evaluates max_iter predecessor window scores for each
    # anchor slot of every batch row (a_cap + the pack's carried-anchor
    # width — 0 on no-prev cycles; reference hot loop: lchain.c:439-505)
    fill_width = a_cap + max((pack.shape[1] - 2) // 3, 0)
    with engine._stats_lock:
        engine.stats["dp_cells"] = engine.stats.get("dp_cells", 0) + (
            sig_dev.shape[0] * fill_width * mo.max_chain_iter
        )
    if engine.dist is not None:
        return engine.dist.step(
            sig_dev, carry, ev_offset, pack,
            q_rank, engine._target_rank, **params,
        )
    from .device_step import chunk_step_aot

    return chunk_step_aot(
        engine.didx, jnp.asarray(sig_dev), carry, ev_offset,
        jnp.asarray(pack), q_rank, engine._target_rank, **params,
    )


def _decode_packed(engine: MappingEngine, hp: np.ndarray):
    """Unpack the fetched anchor words into (key, tpos, qpos, f, p) planes
    (inverse of the device-side packing in device_step.finish_chunk)."""
    kw = engine._key_words
    if hp.dtype == np.int32:
        # wide 5-word i32 layout (large capacities / offsets)
        return (hp[:, :, 0].astype(np.uint32), hp[:, :, 1], hp[:, :, 2],
                hp[:, :, 3], hp[:, :, 4])
    if kw <= 2:
        if kw == 1:
            comb = hp[:, :, 0].astype(np.uint16).astype(np.uint32)
        else:
            comb = (
                hp[:, :, 0].astype(np.uint16).astype(np.uint32)
                | (hp[:, :, 1].astype(np.uint16).astype(np.uint32) << 16)
            )
        pos_mask = np.uint32((1 << engine._pos_bits) - 1)
        rev = (comb >> np.uint32(16 * kw - 1)) & np.uint32(1)
        tid = (comb >> np.uint32(engine._pos_bits)) & np.uint32(
            (1 << engine._tid_bits) - 1
        )
        h_key = (rev << np.uint32(31)) | tid
        h_tpos = (comb & pos_mask).astype(np.int32)
    else:
        h_key = (
            hp[:, :, 0].astype(np.uint16).astype(np.uint32)
            | (hp[:, :, 1].astype(np.uint16).astype(np.uint32) << 16)
        )
        h_tpos = (
            hp[:, :, 2].astype(np.uint16).astype(np.uint32)
            | (hp[:, :, 3].astype(np.uint16).astype(np.uint32) << 16)
        ).view(np.int32)
    return (h_key, h_tpos, hp[:, :, kw].astype(np.int32),
            hp[:, :, kw + 1].astype(np.int32),
            hp[:, :, kw + 2].astype(np.int32))


def _quarantine_overflow(engine: MappingEngine, st: _BatchState,
                         sig_dev, pack, h_scal):
    """Re-run ONLY the rows whose seed hits overflowed a_cap, in a compact
    sub-batch at a grown capacity (zero-truncation without growing the main
    program).  Growing the WHOLE batch for one repeat-heavy read multiplies
    every row's sort/fill width and the packed D2H by the outlier's needs —
    measured 150+ MB fetches at 100 Mbp scale.  Rows pad to a power of two
    and capacities snap to the ladder, so sub-programs cache well.

    Returns {row: (key, tpos, qpos, f, p, n_anchors)} for resolved rows.
    Reference semantics preserved: hits are never dropped (rh_kvec growth,
    rseed.c:105-154) until the --max-anchor-cap ceiling."""
    import jax.numpy as jnp

    cap_ceil = int(engine.mopt.max_anchor_cap)
    rows = np.nonzero(h_scal[:, 4] > 0)[0]
    if rows.size == 0:
        return {}
    if cap_ceil <= st.a_cap:  # hard cap already reached: truncation stands
        with engine._stats_lock:
            engine.stats["hit_overflow"] += int(h_scal[rows, 4].sum())
        return {}
    # two sub-batch sizes only (64 rows or the full batch): every distinct
    # row count is a separate compile, and the quarantine fires rarely
    # enough that padding waste is irrelevant
    live_b = st.frame.shape[0] if st.frame is not None else st.b
    r_pad = min(64, st.disp_b) if rows.size <= 64 else st.disp_b
    if engine.dist is not None:
        # sharded sub-batch must tile the (dp, shard) mesh exactly
        r_pad = engine.dist.pad_batch(r_pad)
    rows_d = jnp.asarray(rows)
    sig_sub = np.zeros((r_pad,) + sig_dev.shape[1:], sig_dev.dtype)
    sig_sub[: rows.size] = sig_dev[rows]
    pack_sub = np.zeros((r_pad, pack.shape[1]), pack.dtype)
    pack_sub[: rows.size] = pack[rows]
    carry_sub = NormCarry(
        jnp.zeros(r_pad, jnp.float32).at[: rows.size].set(st.carry.sum[rows_d]),
        jnp.zeros(r_pad, jnp.float32).at[: rows.size].set(
            st.carry.sum_sq[rows_d]),
        jnp.zeros(r_pad, jnp.int32).at[: rows.size].set(st.carry.n[rows_d]),
    )
    evo_sub = jnp.zeros(r_pad, jnp.int32).at[: rows.size].set(
        st.ev_offset[rows_d])
    qr_sub = jnp.zeros(r_pad, jnp.int32).at[: rows.size].set(
        st.q_rank_dev[rows_d])

    sub_a = st.a_cap
    need = int(h_scal[rows, 4].max())
    p_used = max((pack.shape[1] - 2) // 3, 0)
    while True:
        # one regrow per capacity-growth pass (the dist path counts the
        # same way, so the stat is comparable across engine modes)
        with engine._stats_lock:
            engine.stats["anchor_regrows"] = (
                engine.stats.get("anchor_regrows", 0) + 1
            )
        sub_a = min(_pow2_up(max(sub_a + need, 2 * sub_a)), cap_ceil)
        wide_sub = st.wide or (sub_a + p_used >= (1 << 15))
        out = _dispatch_step(
            engine, st, sig_sub, pack_sub, a_cap=sub_a, wide=wide_sub,
            carry=carry_sub, ev_offset=evo_sub, q_rank=qr_sub, flat_cap=0,
        )
        scal = np.asarray(out.scalars)[: rows.size]
        need = int(scal[:, 4].max()) if scal.size else 0
        if need <= 0 or sub_a >= cap_ceil:
            break
    nmax = int(scal[:, 0].max()) if scal.size else 0
    # pow2 fetch width: every distinct slice width is a separate device
    # program whose LOAD can stall seconds on this infra
    ncut = min(out.packed.shape[1], max(128, _pow2_up(nmax)))
    hp = np.asarray(out.packed[:, :ncut, :])[: rows.size]
    _acct_bytes(engine, "d2h_bytes", hp.nbytes)
    _acct_bytes(engine, "d2h_quarantine", hp.nbytes)
    key, tpos, qpos, f, p = _decode_packed(engine, hp)
    # unresolved residue past the hard cap stays counted as overflow.
    # NOTE: quarantined rows feed _learned_need only up to the main
    # program's a_cap (capped in _process_chunk) — one junk read with
    # 100k+ repeat hits must not drag every batch's main program to its
    # width (observed: a_cap ballooned to 131072 and the per-chunk fetch to
    # 168 MB when the max, not a quantile, was learned)
    with engine._stats_lock:
        engine.stats["hit_overflow"] += int(scal[:, 4].sum())
    if rows.size > live_b // 4 and sub_a > st.a_cap:
        # a quarter of the batch overflowed: the main program is undersized
        # for this workload, so later chunks of THIS batch dispatch at the
        # converged capacity instead of re-quarantining everything
        st.a_cap = sub_a
        st.wide = st.wide or (st.a_cap + st.p_cap >= (1 << 15))
    return {
        int(row): (key[j], tpos[j], qpos[j], f[j], p[j], int(scal[j, 0]))
        for j, row in enumerate(rows)
    }


def _dispatch_step_tail(engine: MappingEngine, st: _BatchState,
                        sig_dev, slen, active_arr):
    """Invoke the device-tail chunk step (also the overflow-retry entry)."""
    import jax.numpy as jnp

    from .device_step import chunk_step_tail_aot as chunk_step_tail

    mo = engine.mopt
    io = engine.iopt
    with engine._stats_lock:
        engine.stats["dp_cells"] = engine.stats.get("dp_cells", 0) + (
            st.disp_b * (st.a_cap + st.p_cap) * mo.max_chain_iter
        )
    if st.prev_dev is None:
        pk = jnp.full((st.disp_b, 8), 0xFFFFFFFF, dtype=jnp.uint32)
        pt = jnp.zeros((st.disp_b, 8), jnp.int32)
        pq = jnp.zeros((st.disp_b, 8), jnp.int32)
        npv = jnp.zeros(st.disp_b, jnp.int32)
    else:
        pk, pt, pq, npv = st.prev_dev
    if engine.dist is not None:
        return engine.dist.step_tail(
            jnp.asarray(sig_dev), st.carry, st.ev_offset,
            pk, pt, pq, npv,
            jnp.asarray(active_arr), jnp.asarray(slen.astype(np.int32)),
            st.q_rank_dev, engine._target_rank,
            diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
            fine_min=io.fine_min, fine_max=io.fine_max,
            fine_range=io.fine_range,
            window_length1=mo.window_length1,
            window_length2=mo.window_length2,
            threshold1=mo.threshold1, threshold2=mo.threshold2,
            peak_height=mo.peak_height,
            e_cap=st.e_cap, a_cap=st.a_cap, k_cap=st.k_cap, p_out=st.p_cap,
            min_events=mo.min_events, mid_occ=int(mo.mid_occ),
            max_dist_t=mo.max_target_gap_length,
            max_dist_q=mo.max_query_gap_length,
            bw=mo.bw, max_iter=mo.max_chain_iter,
            chn_pen_gap=engine.chn_pen_gap, chn_pen_skip=engine.chn_pen_skip,
            min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
            all_vs_all=bool(mo.flag & MapFlag.ALL_CHAINS),
        )
    return chunk_step_tail(
        engine.didx, jnp.asarray(sig_dev), st.carry, st.ev_offset,
        pk, pt, pq, npv,
        jnp.asarray(active_arr), jnp.asarray(slen.astype(np.int32)),
        st.q_rank_dev, engine._target_rank,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max,
        fine_range=io.fine_range,
        window_length1=mo.window_length1,
        window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height,
        e_cap=st.e_cap, a_cap=st.a_cap, k_cap=st.k_cap, p_out=st.p_cap,
        min_events=mo.min_events, mid_occ=int(mo.mid_occ),
        max_dist_t=mo.max_target_gap_length,
        max_dist_q=mo.max_query_gap_length,
        bw=mo.bw, max_iter=mo.max_chain_iter,
        chn_pen_gap=engine.chn_pen_gap, chn_pen_skip=engine.chn_pen_skip,
        min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
        all_vs_all=bool(mo.flag & MapFlag.ALL_CHAINS),
        flat_cap=st.fk_cap,
    )


class _FlatSummaries:
    """Row-indexable view over the flat live-chain summary buffer: hs[j]
    yields dispatch row j's [n_u_j, 10] block (all rows valid), the shape
    gen_regs_from_summaries consumes."""

    def __init__(self, flat: np.ndarray, offs: np.ndarray, n_u: np.ndarray):
        self.flat = flat
        self.offs = offs
        self.n_u = n_u

    def __getitem__(self, j: int) -> np.ndarray:
        o = int(self.offs[j])
        return self.flat[o : o + int(self.n_u[j])]


def _process_chunk_tail(engine: MappingEngine, st: _BatchState) -> None:
    """Host side of a device-tail chunk: fetch per-chain summaries, build
    regions, assign MAPQ, decide (reference: rmap.cpp:415-500 — but the
    backtrack/compaction already happened on-device)."""
    from ..chain.regions import gen_regs_from_summaries

    mo = engine.mopt
    out = st.pending
    slen = st.pending_slen
    spec_k = st.pending_spec  # speculative summaries prefix (async D2H)
    sig_dev, slen_arr, active_arr = st.pending_inputs
    st.pending = st.pending_slen = st.pending_inputs = None
    st.pending_spec = None
    t_wait = time.perf_counter()
    hrows = st.frame if st.frame is not None else np.arange(st.b)
    n_live = hrows.shape[0]
    h_scal = np.asarray(out.scalars)[:n_live]
    if engine.dist is not None and out.shard_hits is not None:
        # per-shard work-balance observability (same as the host-tail path)
        sh = np.asarray(out.shard_hits).astype(np.int64)
        with engine._stats_lock:
            tot = engine.stats.get("shard_hits")
            engine.stats["shard_hits"] = sh if tot is None else tot + sh
    # zero-truncation retry: grow whichever capacity overflowed (hit slots,
    # chain summaries, carried anchors) and re-run with the SAME inputs —
    # carry/prev are committed only after the retry, so the rerun is exact
    cap_ceil = int(mo.max_anchor_cap)
    while cap_ceil > 0:
        need_a = int(h_scal[:, 4].max()) if h_scal.size else 0
        need_k = int(h_scal[:, 6].max()) if h_scal.size else 0
        need_p = int(h_scal[:, 7].max()) if h_scal.size else 0
        need_f = (
            int(h_scal[:, 8].max())
            if h_scal.size and h_scal.shape[1] > 8 else 0
        )
        grew = False
        if need_a > 0 and st.a_cap < cap_ceil:
            new_cap = 1 << int(np.ceil(np.log2(st.a_cap + need_a)))
            st.a_cap = min(max(new_cap, 2 * st.a_cap), cap_ceil)
            grew = True
        if need_k > 0 and st.k_cap < cap_ceil:
            new_k = 1 << int(np.ceil(np.log2(st.k_cap + need_k)))
            st.k_cap = min(max(new_k, 2 * st.k_cap), cap_ceil)
            grew = True
        if need_p > 0 and st.p_cap < cap_ceil:
            new_p = 1 << int(np.ceil(np.log2(st.p_cap + need_p)))
            st.p_cap = min(max(new_p, 2 * st.p_cap), cap_ceil)
            grew = True
        if need_f > 0:
            # flat summary buffer too small for the live chains: pow2 regrow
            # (no ceiling — it is O(total chains), tiny next to the anchors)
            st.fk_cap = 1 << int(np.ceil(np.log2(st.fk_cap + need_f)))
            grew = True
        if not grew:
            break
        with engine._stats_lock:
            engine.stats["anchor_regrows"] = (
                engine.stats.get("anchor_regrows", 0) + 1
            )
        out = _dispatch_step_tail(engine, st, sig_dev, slen_arr, active_arr)
        spec_k = None  # capacities changed: the prefetched slice is stale
        h_scal = np.asarray(out.scalars)[:n_live]
    # feed the converged capacities back so the NEXT batch starts there
    # instead of re-growing the whole batch every pass (tail growth is
    # whole-batch: 2-3 extra full dispatches per chunk observed at 100 Mbp)
    with engine._stats_lock:
        if st.a_cap > engine._learned_need:
            engine._learned_need = st.a_cap
        if st.k_cap > engine._learned_kcap:
            engine._learned_kcap = st.k_cap
        if st.p_cap > engine._learned_pcap:
            engine._learned_pcap = st.p_cap
        if st.fk_cap > engine._learned_fk:
            engine._learned_fk = st.fk_cap
    st.carry = out.carry
    st.ev_offset = out.ev_offset
    st.prev_dev = (out.prev_key, out.prev_tpos, out.prev_qpos, out.n_prev)

    h_rep = h_scal[:, 1]
    h_proc = h_scal[:, 3] != 0
    h_evoff = h_scal[:, 5]
    act = st.active[hrows]
    with engine._stats_lock:
        engine.stats["hit_overflow"] += int(h_scal[act, 4].sum())
        engine.stats["prev_overflow"] += int(h_scal[act, 7].sum())
        engine.stats["chain_overflow"] = engine.stats.get(
            "chain_overflow", 0
        ) + int(h_scal[act, 6].sum())
        engine.stats["device_tail_chunks"] = (
            engine.stats.get("device_tail_chunks", 0) + 1
        )
    # fetch the WHOLE summaries buffer: it is small (B x k_cap x 10 i32,
    # ~650 KB at defaults), its copy_to_host_async started at submit time,
    # and slicing it at a data-dependent kcut would compile+load a fresh
    # device program per distinct chain count
    n_u_max = int(h_scal[:, 0].max()) if h_scal.size else 0
    if out.summ_flat is not None:
        # O(live chains) fetch: chains are packed back-to-back at
        # cumsum(n_u) offsets over the dispatch rows (device_step.tail_finish)
        flat = np.asarray(out.summ_flat)
        n_u_rows = np.asarray(out.scalars[:, 0])
        offs = np.cumsum(n_u_rows) - n_u_rows
        hs = _FlatSummaries(flat, offs[:n_live], h_scal[:, 0])
        _acct_bytes(engine, "d2h_bytes", flat.nbytes + 4 * out.scalars.size)
        _acct_bytes(engine, "d2h_summ", flat.nbytes)
    elif spec_k is not None and spec_k.shape[1] >= n_u_max:
        hs = np.asarray(spec_k)[:n_live]
        _acct_bytes(engine, "d2h_bytes", hs.nbytes + 4 * out.scalars.size)
        _acct_bytes(engine, "d2h_summ", hs.nbytes)
    else:
        hs = np.asarray(out.summaries)[:n_live]
        _acct_bytes(engine, "d2h_bytes", hs.nbytes + 4 * out.scalars.size)
        _acct_bytes(engine, "d2h_summ", hs.nbytes)
    # next chunk's speculative chain-count width (pow2 ladder; dense mode)
    kw = 64
    while kw < n_u_max:
        kw *= 2
    engine._spec_kcut = kw
    with engine._stats_lock:
        engine.profiler.add(st.stage_prefix + "device+transfer", time.perf_counter() - t_wait)

    c = st.chunk_idx
    now = time.perf_counter()
    t_host = now
    all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
    for j, i in enumerate(hrows):
        if not st.active[i]:
            continue
        if slen[j] == 0:
            st.active[i] = False
            continue
        st.c_counts[i] = c
        if not h_proc[j]:
            st.last_regs[i] = []
            continue
        st.ev_totals[i] = int(h_evoff[j])
        # read hash (reference: rmap.cpp:346-348)
        h = 0
        h ^= (wang_hash32(int(h_evoff[j])) + wang_hash32(11)) & 0xFFFFFFFF
        h = wang_hash32(h)
        sj = hs[j][: int(h_scal[j, 0])]
        # native fused pipeline prunes BEFORE building Python Region
        # objects (a 100 Mbp chunk carries ~600k live chains; object
        # construction alone cost seconds)
        from .._native import gen_regions_summ_native

        regs = gen_regions_summ_native(
            h, sj, engine.span,
            mo.mask_level, mo.mask_len,
            bool(mo.flag & MapFlag.HARD_MLEVEL), mo.alt_drop,
            not all_chains, mo.pri_ratio, mo.best_n, True,
            int(mo.max_target_gap_length * 0.8),
        )
        if regs is None:  # no native toolchain: python oracle path
            regs = gen_regs_from_summaries(h, sj, engine.span)
            set_parent(
                regs, mo.mask_level, mo.mask_len,
                bool(mo.flag & MapFlag.HARD_MLEVEL), mo.alt_drop,
            )
            if not all_chains:
                regs = select_sub(
                    regs, mo.pri_ratio, mo.best_n, True,
                    int(mo.max_target_gap_length * 0.8),
                )
        st.last_regs[i] = regs
        set_mapq(regs, mo.min_chaining_score, int(h_rep[j]), False)
        ids, done = engine._decide(regs, False)
        if done:
            st.map_ids[i] = ids
            st.t_decided[i] = now
            st.active[i] = False
    with engine._stats_lock:
        engine.profiler.add(st.stage_prefix + "host_chain_tail", time.perf_counter() - t_host)
    st.chunk_idx += 1


def _acct_bytes(engine: MappingEngine, key: str, nbytes: int) -> None:
    """Accumulate transferred bytes (h2d_bytes / d2h_bytes); the bench
    publishes bytes/read per workload."""
    with engine._stats_lock:
        engine.stats[key] = engine.stats.get(key, 0) + int(nbytes)


def _submit_chunk(engine: MappingEngine, st: _BatchState):
    """Enqueue the device chunk step (async dispatch — returns immediately
    with lazy outputs, so another batch's host tail can overlap)."""
    import jax.numpy as jnp

    mo = engine.mopt
    c = st.chunk_idx
    no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
    _maybe_compact_frame(engine, st)
    # dispatch row j <-> host row hrows[j] (identity before any framing)
    hrows = st.frame if st.frame is not None else np.arange(st.b)
    chunk = np.zeros((st.disp_b, st.l_chunk), dtype=np.float32)
    slen = np.zeros(st.disp_b, dtype=np.int32)
    for j, i in enumerate(hrows):
        if not st.active[i]:
            continue
        if no_adaptive:
            seg = st.sigs[i][: st.l_chunk]
        else:
            seg = st.sigs[i][c * st.l_chunk : (c + 1) * st.l_chunk]
        chunk[j, : seg.shape[0]] = seg
        slen[j] = seg.shape[0]
    t_sub = time.perf_counter()
    sig_dev = chunk.astype(engine.signal_dtype)
    if st.tail:
        active_arr = np.zeros(st.disp_b, dtype=np.int32)
        active_arr[: hrows.shape[0]] = st.active[hrows]
        _acct_bytes(engine, "h2d_bytes", sig_dev.nbytes)
        out = _dispatch_step_tail(engine, st, sig_dev, slen, active_arr)
        now = time.perf_counter()
        # tail dispatch = H2D sig upload + program enqueue; a long stall
        # here is enqueue BACKPRESSURE from the previous chunk's device work
        engine.profiler.add(st.stage_prefix + "submit:dispatch", now - t_sub)
        engine.profiler.add(st.stage_prefix + "submit", now - t_sub)
        # speculative chain-count slice: the summaries buffer is
        # [disp_b, k_cap, 10] i32 and k_cap can learn to thousands at
        # 100 Mbp scale (42 MB/chunk); chunk-to-chunk
        # chain counts are stable, so prefetch a pow2 prefix sized from the
        # last chunk's max n_u (exact-width fallback when it undershoots)
        spec_k = None
        if out.summ_flat is None:
            kw = min(engine._spec_kcut, out.summaries.shape[1])
            if 0 < kw < out.summaries.shape[1]:
                spec_k = out.summaries[:, :kw, :]
        st.pending_spec = spec_k
        try:
            out.scalars.copy_to_host_async()
            if out.summ_flat is not None:
                out.summ_flat.copy_to_host_async()
            else:
                (spec_k if spec_k is not None else out.summaries).copy_to_host_async()
        except Exception:
            pass
        st.pending = out
        st.pending_slen = slen
        st.pending_inputs = (sig_dev, slen, active_arr)
        return
    # single packed i32 upload: carried anchors + n_prev + slen (one H2D
    # transfer instead of four).  The pack uploads at the LIVE carried-anchor
    # width on a coarse pow4 ladder {8, 32, 128, ...}, not at p_cap: the
    # pack is O(B x 3*width) i32, and at ecoli/100 Mbp scale p_cap inflates
    # to 4x a_cap while the widest live row is typically far narrower.  The
    # device reads the width from the pack shape (decode_prev_pack) and the
    # merge/sort/fill width shrinks from a_cap + p_cap to a_cap + width with
    # identical results (slots past n_prev are masked either way).  The
    # ladder is pow4 because every step is its own XLA compile
    # (persistent-cached across processes); width 8 also serves the
    # no-carried-anchors chunks, so there is no separate empty-pack
    # signature to pre-compile.
    import os as _os

    n_live = hrows.shape[0]
    if not _os.environ.get("RAWHASH_TPU_FULL_PACK"):
        # live-width pow4 ladder for the dist path too (pinned at p_cap it
        # pays the full-width H2D every chunk); the shard_map program reads
        # the width from the pack shape and the batch rows stay mesh-tiled
        # regardless of pack width
        p_use = 8
        while p_use < int(st.n_prev[hrows].max()):
            p_use *= 4
        p_use = min(p_use, st.p_cap)
    else:
        p_use = st.p_cap
    pack = np.zeros((st.disp_b, 3 * p_use + 2), dtype=np.int32)
    pack[:n_live, :p_use] = st.prev_key[hrows, :p_use].view(np.int32)
    pack[:n_live, p_use : 2 * p_use] = st.prev_tpos[hrows, :p_use]
    pack[:n_live, 2 * p_use : 3 * p_use] = st.prev_qpos[hrows, :p_use]
    pack[:n_live, 3 * p_use] = st.n_prev[hrows]
    pack[:, 3 * p_use + 1] = slen
    _acct_bytes(engine, "h2d_bytes", sig_dev.nbytes + pack.nbytes)
    t_disp = time.perf_counter()
    out = _dispatch_step(engine, st, sig_dev, pack)
    now = time.perf_counter()
    # sub-attribution: pack assembly (host numpy) vs dispatch (H2D upload +
    # program enqueue) — the 100 Mbp-scale "submit" mystery lives here
    engine.profiler.add(st.stage_prefix + "submit:pack", t_disp - t_sub)
    engine.profiler.add(st.stage_prefix + "submit:dispatch", now - t_disp)
    engine.profiler.add(st.stage_prefix + "submit", now - t_sub)
    # start D2H copies NOW (async): the scalar block always, plus a
    # speculative prefix of the packed anchors sized from the last chunk's
    # live width.  Both transfer while other batches compute; the
    # worker thread then usually finds its bytes already on the host instead
    # of paying two sequential round trips (scalars -> exact-width fetch).
    try:
        out.scalars.copy_to_host_async()
    except Exception:
        pass
    st.pending_rows = None
    spec = None
    if out.packed_flat is not None:
        # speculative pow2 prefix sized by the last chunk's live total:
        # fp_cap is a high-water ladder, but straggler chunks carry far
        # fewer anchors — fetching the whole buffer every chunk gave back
        # the exact-count win
        fcut = min(engine._spec_ftot, out.packed_flat.shape[0])
        if 0 < fcut < out.packed_flat.shape[0]:
            spec = out.packed_flat[:fcut]
        else:
            spec = out.packed_flat
        try:
            spec.copy_to_host_async()
        except Exception:
            pass
    else:
        # straggler row-slicing: late chunks of a batch keep only a few
        # reads alive, but a full-buffer fetch still moves b_dev * ncut *
        # words bytes.  When the live rows fit a {64,128,...} ladder step
        # below b_dev, fetch packed[rows, :w] via a gather program (rows is
        # a TRACED argument, so the ladder bounds the signature count).
        # DTW mode keeps the full fetch (its events buffer is full-frame
        # anyway).
        rows = np.nonzero(slen[:n_live] > 0)[0]  # dispatch-row indices
        # ladder base 64 (env override exists so tests can exercise the
        # sliced path on tiny CPU batches)
        r_lad = int(_os.environ.get("RAWHASH_TPU_ROW_LADDER_BASE", "64"))
        while r_lad < rows.size:
            r_lad *= 2
        if (
            engine.dist is None
            and not (mo.flag & MapFlag.DTW_EVALUATE_CHAINS)
            and r_lad < st.disp_b
        ):
            st.pending_rows = rows
            st.pending_rows_pad = np.zeros(r_lad, dtype=np.int32)
            st.pending_rows_pad[: rows.size] = rows
        spec_w = min(engine._spec_ncut, out.packed.shape[1])
        if spec_w >= 128:
            from .device_step import gather_rows_aot

            if st.pending_rows is not None:
                spec = gather_rows_aot(
                    out.packed, jnp.asarray(st.pending_rows_pad), ncut=spec_w
                )
            else:
                spec = out.packed[:, :spec_w, :]
            try:
                spec.copy_to_host_async()
            except Exception:
                pass
    st.pending_spec = spec
    st.pending = out
    st.pending_slen = slen
    st.pending_inputs = (sig_dev, pack)


def _process_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """Host tail of an in-flight chunk: backtrack, regions, MAPQ, decisions
    (reference: rmap.cpp:415-500)."""
    if st.tail:
        return _process_chunk_tail(engine, st)
    mo = engine.mopt
    is_dtw = bool(mo.flag & MapFlag.DTW_EVALUATE_CHAINS)
    out = st.pending
    slen = st.pending_slen
    spec = st.pending_spec
    sig_dev, pack = st.pending_inputs
    fetch_rows = st.pending_rows  # straggler row-slice (None = full frame)
    fetch_rows_pad = st.pending_rows_pad
    st.pending = st.pending_slen = st.pending_spec = None
    st.pending_inputs = st.pending_rows = st.pending_rows_pad = None
    t_wait = time.perf_counter()
    import os as _os

    trace = _os.environ.get("RAWHASH_TPU_TRACE_CHUNK")
    # dispatch row j <-> host row hrows[j] (identity before any framing)
    hrows = st.frame if st.frame is not None else np.arange(st.b)
    n_live = hrows.shape[0]
    # D2H: the tiny scalar block (already en route — copy_to_host_async at
    # submit) gives the exact live-anchor width; if the speculative prefix
    # started at submit covers it, its bytes are usually already here,
    # otherwise fall back to one exact-width fetch (anchors are sorted
    # valid-first; width rounds up to 128 so the slice program compiles only
    # a handful of variants)
    h_scal = np.asarray(out.scalars)[:n_live]
    # --- zero-truncation retry (reference semantics: hits are never
    # dropped — rh_kvec growth, rseed.c:105-154).  Single-device engines
    # QUARANTINE: only the rows whose hits overflowed re-run, in a compact
    # grown sub-batch, so one repeat-heavy read does not multiply every
    # row's fill width and packed D2H (carry/ev_offset are committed after,
    # so the rerun is exact).  The sharded engine quarantines too, with the
    # sub-batch padded to tile the (dp, shard) mesh.
    if trace:
        print(f"[trace] scalars: {time.perf_counter()-t_wait:.3f}s",
              flush=True)
    # EARLY tail switch (chunk 0 only, before the packed-anchor fetch):
    # at 100 Mbp+ scale the very first chunk's host-tail fetch would move
    # O(B x anchors) bytes (755 MB once at 100 Mbp) just to learn what the
    # scalars already say — the watermark is over the threshold.  Chunk 0
    # has no carried anchors, so re-dispatching the SAME inputs through
    # the device tail is exact (carry/ev_offset commit only afterwards).
    if (
        engine._tail_auto
        and not st.tail
        and st.chunk_idx == 0
        and h_scal.size
    ):
        wm_rows = h_scal[:, 0] + h_scal[:, 4]
        wm0 = int(np.quantile(wm_rows, 0.95))
        if wm0 > engine.tail_switch_anchors:
            with engine._stats_lock:
                if wm0 > engine._learned_need:
                    engine._learned_need = wm0
                if not engine.device_tail:
                    print(
                        f"[rawhash-tpu] chunk-0 anchor watermark {wm0} > "
                        f"{engine.tail_switch_anchors}: switching to the "
                        "device-tail path before the anchor fetch",
                        file=sys.stderr,
                    )
                    engine.device_tail = True
            st.tail = True
            st.pending = st.pending_slen = st.pending_inputs = None
            st.pending_spec = None
            _submit_chunk(engine, st)
            _process_chunk_tail(engine, st)
            return
    # flat packed-anchor overflow: total live anchors exceeded fp_cap, so
    # some rows' anchors were dropped from the flat buffer — regrow (pow2)
    # and re-dispatch the same inputs (carry commits only afterwards)
    while (
        out.packed_flat is not None
        and h_scal.size
        and h_scal.shape[1] > 6
        and int(h_scal[:, 6].max()) > 0
    ):
        need_fp = int(h_scal[:, 6].max())
        st.fp_cap = 1 << int(np.ceil(np.log2(st.fp_cap + need_fp)))
        with engine._stats_lock:
            engine.stats["anchor_regrows"] = (
                engine.stats.get("anchor_regrows", 0) + 1
            )
        out = _dispatch_step(engine, st, sig_dev, pack)
        h_scal = np.asarray(out.scalars)[:n_live]
        spec = None
    if out.packed_flat is not None:
        with engine._stats_lock:
            if st.fp_cap > engine._learned_fp:
                engine._learned_fp = st.fp_cap
    t_q = time.perf_counter()
    overrides = _quarantine_overflow(engine, st, sig_dev, pack, h_scal)
    if trace:
        print(f"[trace] quarantine({len(overrides)} rows): "
              f"{time.perf_counter()-t_q:.3f}s", flush=True)
    if engine.dist is not None and out.shard_hits is not None:
        # per-shard work-balance observability: accumulate each device's
        # locally-owned post-filter hit totals ((dp, shard) flattened)
        sh = np.asarray(out.shard_hits).astype(np.int64)
        with engine._stats_lock:
            tot = engine.stats.get("shard_hits")
            engine.stats["shard_hits"] = (
                sh if tot is None else tot + sh
            )
    st.carry = out.carry
    st.ev_offset = out.ev_offset
    h_nanc = h_scal[:, 0]
    h_rep = h_scal[:, 1]
    h_nev = h_scal[:, 2]
    h_proc = h_scal[:, 3] != 0
    h_evoff = h_scal[:, 5]
    ncols = out.packed.shape[1]
    if overrides:
        # quarantined rows' anchors arrive via their own sub-fetch; the
        # main fetch width follows the widest CLEAN row only
        clean = np.ones(n_live, bool)
        clean[list(overrides)] = False
        nmax = int(h_nanc[clean].max()) if clean.any() else 0
    else:
        nmax = int(h_nanc.max()) if h_nanc.size else 0
    # pow2 fetch width (not multiples of 128): each distinct slice width
    # compiles+loads its own device program — the ladder caps the variant
    # count at log2(n)
    fk_pl = None
    if out.packed_flat is not None:
        # exact-count flat fetch: O(total live anchors) bytes.  Fetch a
        # pow2 prefix covering this chunk's total (fp_cap is a high-water
        # ladder); the speculative prefix from submit time usually already
        # covers it
        n_all = np.asarray(out.scalars[:, 0])
        total = int(n_all.sum())
        fcut = min(out.packed_flat.shape[0], max(1024, _pow2_up(total)))
        if spec is not None and spec.ndim == 2 and spec.shape[0] >= total:
            flat = np.asarray(spec)
        else:
            flat = np.asarray(out.packed_flat[:fcut])
        engine._spec_ftot = fcut
        _acct_bytes(engine, "d2h_bytes", flat.nbytes + 4 * out.scalars.size)
        _acct_bytes(engine, "d2h_packed", flat.nbytes)
        foffs = np.cumsum(n_all) - n_all
        fk_pl = _decode_packed(engine, flat[None, :, :])
        fk_pl = tuple(p[0] for p in fk_pl)
        pos_of = None
        hp = None
        ncut = 0
    else:
        ncut = min(ncols, max(128, _pow2_up(nmax)))
        if spec is not None and spec.shape[1] >= ncut:
            hp = np.asarray(spec)[:, :ncut, :]
            if fetch_rows is None:
                hp = hp[:n_live]
        elif fetch_rows is not None:
            import jax.numpy as jnp

            from .device_step import gather_rows_aot

            hp = np.asarray(
                gather_rows_aot(out.packed, jnp.asarray(fetch_rows_pad), ncut=ncut)
            )
        else:
            hp = np.asarray(out.packed[:, :ncut, :])[:n_live]
        # packed-derived planes index by fetch position when row-sliced
        pos_of = (
            None if fetch_rows is None
            else {int(r): j for j, r in enumerate(fetch_rows)}
        )
    # next chunk's speculative width: this chunk's pow2 fetch width (chunk-
    # to-chunk widths are stable, so the prefix usually covers; when it
    # falls short the exact-width fallback costs one extra sync fetch).
    # NOT the next ladder step up: doubling every prefetch moves twice the
    # bytes to save an occasional fallback (not yet measured on the H100).
    # (benign cross-batch race: plain int store)
    if fk_pl is None:
        engine._spec_ncut = min(ncols, ncut)
        _acct_bytes(engine, "d2h_bytes", hp.nbytes + 4 * out.scalars.size)
        _acct_bytes(engine, "d2h_packed", hp.nbytes)
        h_key, h_tpos, h_qpos, h_f, h_p = _decode_packed(engine, hp)
    else:
        h_key = h_tpos = h_qpos = h_f = h_p = None
    if trace:
        print(f"[trace] packed fetch ncut={ncut} flat={fk_pl is not None} "
              f"spec={spec is not None}: "
              f"{time.perf_counter()-t_q:.3f}s cumulative", flush=True)
    if is_dtw:
        h_events = np.asarray(out.events)[:n_live].astype(np.float32)
        _acct_bytes(engine, "d2h_bytes", h_events.nbytes)
    with engine._stats_lock:
        engine.profiler.add(st.stage_prefix + "device+transfer", time.perf_counter() - t_wait)

    c = st.chunk_idx
    now = time.perf_counter()
    t_host = now
    pending = []  # (i, regs, chain_axy) awaiting DTW + decision
    wms = []  # per-read anchor watermarks feeding _plan's learned sizing
    for j, i in enumerate(hrows):
        if not st.active[i]:
            continue
        if slen[j] == 0:
            st.active[i] = False
            st.n_prev[i] = 0
            continue
        st.c_counts[i] = c
        if not h_proc[j]:
            st.last_regs[i] = []
            continue
        if is_dtw:
            st.all_events[i].append(h_events[j, : h_nev[j]].copy())
        st.ev_totals[i] = int(h_evoff[j])
        ov = overrides.get(j)
        if ov is not None:  # quarantined row: grown-capacity rerun results
            k_i, t_i, q_i, f_i, p_i, n_i = ov
        elif fk_pl is not None:
            o = int(foffs[j])
            n_i = int(h_nanc[j])
            k_i = fk_pl[0][o : o + n_i]
            t_i = fk_pl[1][o : o + n_i]
            q_i = fk_pl[2][o : o + n_i]
            f_i = fk_pl[3][o : o + n_i]
            p_i = fk_pl[4][o : o + n_i]
        else:
            hj = j if pos_of is None else pos_of[j]
            k_i, t_i, q_i, f_i, p_i, n_i = (
                h_key[hj], h_tpos[hj], h_qpos[hj], h_f[hj], h_p[hj], h_nanc[j]
            )
        # quarantined rows count toward the watermark only up to the main
        # program's current width: their grown-capacity n_i must not drag
        # the p95 (and with it a_cap and the per-chunk fetch) to outlier
        # width when >5% of a batch is repeat-heavy — that damping lives in
        # the mass-quarantine raise at _quarantine_overflow instead
        if ov is not None:
            wms.append(min(int(n_i), st.a_cap))
        else:
            wms.append(int(n_i) + int(h_scal[j, 4]))
        regs, chain_axy, (px, py) = engine._chunk_tail(
            k_i, t_i, q_i, n_i, f_i, p_i, int(h_evoff[j]),
        )
        st.last_regs[i] = regs
        if px.shape[0] > st.p_cap and mo.max_anchor_cap > 0:
            # grow the carried-anchor width: the reference carries EVERY
            # chain anchor to the next chunk (rmap.cpp:111-116)
            st.grow_prev(px.shape[0], int(mo.max_anchor_cap))
        npv = min(px.shape[0], st.p_cap)
        if px.shape[0] > st.p_cap:
            with engine._stats_lock:
                engine.stats["prev_overflow"] += px.shape[0] - st.p_cap
        k2, t2, q2 = _unpack_xy(px[:npv], py[:npv])
        st.prev_key[i, :npv] = k2
        st.prev_tpos[i, :npv] = t2
        st.prev_qpos[i, :npv] = q2
        st.n_prev[i] = npv
        pending.append((i, j, regs, chain_axy))

    if is_dtw:
        # all reads' chain segments in one batched device DTW program
        from ..dtw.evaluate import evaluate_chains_batched

        jobs = [
            (regs, bx, by, np.concatenate(st.all_events[i]))
            for i, _j, regs, (bx, by) in pending
            if regs
        ]
        if jobs:
            evaluate_chains_batched(jobs, engine.index, mo)

    for i, j, regs, _ in pending:
        set_mapq(regs, mo.min_chaining_score, int(h_rep[j]), is_dtw)
        ids, done = engine._decide(regs, is_dtw)
        if done:
            st.map_ids[i] = ids
            st.t_decided[i] = now
            st.active[i] = False
            st.n_prev[i] = 0
    with engine._stats_lock:
        engine.profiler.add(st.stage_prefix + "host_chain_tail", time.perf_counter() - t_host)
        if st.stage_prefix == "" and wms:
            # 95th percentile, not the max: the main program should fit the
            # TYPICAL read; tail outliers stay in the quarantine path, whose
            # 64-row sub-batch costs far less than widening every row's
            # sort/fill/fetch
            wm = int(np.quantile(np.asarray(wms), 0.95))
            if wm > engine._learned_need:
                engine._learned_need = wm
            if (
                engine._tail_auto
                and not engine.device_tail
                and engine._learned_need > engine.tail_switch_anchors
            ):
                # O(anchors) host-tail fetch is now the bottleneck: new
                # batches take the device-tail path (O(chains) D2H)
                engine.device_tail = True
                import sys as _sys

                print(
                    "[rawhash-tpu] anchor watermark "
                    f"{engine._learned_need} > {engine.tail_switch_anchors}:"
                    " switching new batches to the device-tail path",
                    file=_sys.stderr,
                )
    st.chunk_idx += 1


def _finalize_batch(engine: MappingEngine, st: _BatchState) -> list:
    """Build ReadResults (reference: rmap.cpp:507-586)."""
    mo = engine.mopt
    no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
    out_results = []
    now = time.perf_counter()
    for i in range(st.b):
        qlen = int(st.qlens[i])
        cc = 0 if no_adaptive else int(st.c_counts[i])
        regs = st.last_regs[i]
        ids = st.map_ids[i]
        # last-chance accept (reference: rmap.cpp:515-519)
        if ids is None and regs and regs[0].mapq > mo.min_mapq:
            ids = [0]
            st.t_decided[i] = now
        mt = ((st.t_decided[i] if ids is not None else now) - st.t_start[i]) * 1000.0
        offset = int(st.ev_totals[i])
        lc = qlen if (no_adaptive or qlen < st.l_chunk) else st.l_chunk
        if offset == 0 or mo.sample_per_base == 0:
            scale = 0.0
        else:
            scale = ((cc + 1) * lc / offset) / mo.sample_per_base
        recs = []
        sig_t = engine.index.sig_target
        if ids:
            for ic in ids:
                r = regs[ic]
                tags = engine._tags(mt, cc + 1, qlen, r.cnt, len(regs), r.score)
                frag_start = (
                    int(engine.index.seq_lens[r.rid]) + 1 - r.re if r.rev else r.rs
                )
                if sig_t:
                    rl, rqs, rqe = offset, r.qs, r.qe
                else:
                    rl = int(scale * r.qe)
                    rqs, rqe = int(scale * r.qs), int(scale * r.qe)
                recs.append(
                    MapRecord(
                        read_length=rl, ref_id=r.rid, read_start=rqs,
                        read_end=rqe, frag_start=frag_start,
                        frag_len=r.re - r.rs + 1, mapq=r.mapq,
                        rev=r.rev, mapped=1, tags=tags,
                    )
                )
            engine.stats["mapped"] += 1
        else:
            if regs:
                tags = engine._tags(mt, cc + 1, qlen, regs[0].cnt, len(regs),
                                    regs[0].score)
            else:
                tags = engine._tags(mt, cc + 1, qlen, 0, 0, 0)
            rl = offset if sig_t else int(scale * offset)
            recs.append(MapRecord(read_length=rl, mapped=0, tags=tags))
        engine.stats["reads"] += 1
        out_results.append(ReadResult(name=st.names[i], records=recs))
    return out_results


def _map_stream_impl(engine: MappingEngine, batches):
    """`pipeline_depth` batches in flight, with each batch's D2H fetch +
    host chain tail running in a worker thread (the kt_pipeline overlap,
    reference: kthread.c:130).

    A batch spends part of its wall time blocked in D2H transfers, and
    both the transfers (GIL released)
    and the native region pipeline (ctypes releases the GIL) of different
    batches overlap freely.  Device dispatch stays on the caller thread;
    per-batch order is enforced by the future chain, global output order by
    the reorder buffer."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    depth = max(1, int(getattr(engine.mopt, "pipeline_depth", 3)))
    batches = iter(batches)
    inflight: collections.deque = collections.deque()
    results: dict = {}
    next_in = 0
    next_out = 0

    with ThreadPoolExecutor(max_workers=min(depth, 3)) as pool:

        def pull():
            nonlocal next_in
            try:
                reads = next(batches)
            except StopIteration:
                return False
            st = _BatchState(engine, reads)
            st.order = next_in
            next_in += 1
            _submit_chunk(engine, st)
            st.future = pool.submit(_process_chunk, engine, st)
            inflight.append(st)
            return True

        for _ in range(depth):
            pull()
        while inflight:
            st = inflight.popleft()
            st.future.result()
            if st.done():
                results[st.order] = _finalize_batch(engine, st)
                if len(inflight) < depth:
                    pull()
            else:
                _submit_chunk(engine, st)
                st.future = pool.submit(_process_chunk, engine, st)
                inflight.append(st)
            while next_out in results:
                yield results.pop(next_out)
                next_out += 1
    while next_out in results:
        yield results.pop(next_out)
        next_out += 1


def _map_batch_impl(engine: MappingEngine, reads: list) -> list:
    for res in _map_stream_impl(engine, [reads]):
        return res
    return []


MappingEngine.map_stream = _map_stream_impl
MappingEngine.map_batch = _map_batch_impl


def _tags_impl(self, mt_ms, ci, sl, cm, nc, s1):
    """PAF tag block (reference: rmap.cpp:527-570).

    `sm:f` mirrors the reference byte-for-byte: its `mean_chain_score` is
    declared 0 and never assigned (rmap.cpp:513), so mapped/with-chain reads
    print "sm:f:0.00" and the no-chain unmapped branch prints the literal
    "sm:f:0" (rmap.cpp:541)."""
    sm = "0" if nc == 0 else "0.00"
    return (
        f"mt:f:{mt_ms:.6f}\tci:i:{ci}\tsl:i:{sl}\tcm:i:{cm}"
        f"\tnc:i:{nc}\ts1:i:{s1}\tsm:f:{sm}"
    )


MappingEngine._tags = _tags_impl
