"""Option structures, bit-flags, and presets for the rawhash-tpu engine.

Mirrors the capability surface of the reference tool's option system
(reference: src/roptions.{h,c}, src/main.cpp:111-210 presets), re-expressed as
Python dataclasses.  Defaults are kept numerically identical to the reference
defaults so that behaviour (quantization ranges, chaining penalties, decision
weights, ...) matches out of the box.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class IndexFlag(enum.IntFlag):
    """Index-time behaviour flags (reference: src/roptions.h:8-16)."""

    NAIVE = 0x1
    MIN = 0x2
    BLEND = 0x4
    SYNCMER = 0x8
    STORE_SIG = 0x10
    SIG_TARGET = 0x20
    NO_REV_TARGET = 0x40
    OUT_QUANTIZE = 0x80
    NO_EVENT_DETECTION = 0x100


class MapFlag(enum.IntFlag):
    """Mapping-time behaviour flags (reference: src/roptions.h:18-36)."""

    SEQUENCEUNTIL = 0x1
    RMQ = 0x2
    HARD_MLEVEL = 0x4
    NO_SPAN = 0x8
    ALIGN = 0x10
    NO_ADAPTIVE = 0x20
    DTW_EVALUATE_CHAINS = 0x40
    DTW_OUTPUT_CIGAR = 0x80
    DTW_LOG_SCORES = 0x100
    DISABLE_CHAININGSCORE_FILTERING = 0x200
    OUTPUT_CHAINS = 0x400
    LOG_ANCHORS = 0x800
    LOG_NUM_ANCHORS = 0x1000
    ALL_CHAINS = 0x2000
    OUT_ALL_CHAINS = 0x4000


class DtwBorderConstraint(enum.IntEnum):
    """reference: src/roptions.h:39-41"""

    GLOBAL = 0
    SPARSE = 1
    LOCAL = 2


class DtwFillMethod(enum.IntEnum):
    """reference: src/roptions.h:42-43"""

    FULL = 0
    BANDED = 1


@dataclass
class IndexOptions:
    """Indexing options (reference: ri_idxopt_t, src/roptions.h:50-67;
    defaults from ri_idxopt_init, src/roptions.c:4-32)."""

    b: int = 14  # log2 number of hash buckets (kept for artifact parity)
    w: int = 0  # minimizer window (0 = disabled)
    e: int = 8  # events packed per seed
    n: int = 0  # BLEND neighbours (unused; parity field)
    q: int = 4  # quantization bits per event
    k: int = 6  # pore-model k-mer length
    lev_col: int = 1  # column of the level mean in the pore file
    flag: IndexFlag = IndexFlag(0)

    diff: float = 0.35  # event-diff filter threshold
    fine_min: float = -2.0
    fine_max: float = 2.0
    fine_range: float = 0.4

    # segmentation (event detection) parameters
    window_length1: int = 3
    window_length2: int = 9
    threshold1: float = 4.0
    threshold2: float = 3.5
    peak_height: float = 0.4

    # sequencing-device constants
    bp_per_sec: int = 450
    sample_rate: int = 4000

    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000

    @property
    def sample_per_base(self) -> float:
        return float(self.sample_rate) / float(self.bp_per_sec)

    @property
    def span(self) -> int:
        """Seed span in events/bases (reference: rsketch.c:76 `span = k+e-1`)."""
        return self.k + self.e - 1


@dataclass
class MapOptions:
    """Mapping options (reference: ri_mapopt_t, src/roptions.h:69-143;
    defaults from ri_mapopt_init, src/roptions.c:34-138)."""

    # ONT device parameters
    bp_per_sec: int = 450
    sample_rate: int = 4000
    chunk_size: int = 4000

    # seeding
    mid_occ_frac: float = 1e-2
    q_occ_frac: float = 1e-2
    min_mid_occ: int = 50
    max_mid_occ: int = 500_000
    mid_occ: int = 0  # 0 = derive from index occurrence quantile
    max_occ: int = 0
    max_max_occ: int = 32767
    occ_dist: int = 500

    # chaining
    min_events: int = 50
    bw: int = 500
    bw_long: int = 0
    max_target_gap_length: int = 2500
    max_query_gap_length: int = 2500
    max_chain_iter: int = 200
    rmq_inner_dist: int = 1000
    rmq_size_cap: int = 100_000
    max_num_skips: int = 5
    min_num_anchors: int = 2
    min_chaining_score: int = 15
    min_chaining_score2: int = 0
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0

    # mapping-decision weights (reference: rmap.cpp:453-498)
    w_bestq: float = 0.35
    w_besta: float = 0.2
    w_bestma: float = 0.2
    w_bestmq: float = 0.05
    w_bestmc: float = 0.6
    w_threshold: float = 0.45

    mask_level: float = 0.5
    mask_len: int = 2**31 - 1
    pri_ratio: float = 0.3
    best_n: int = 0
    top_n_mean: int = 0
    alt_drop: float = 0.15

    step_size: int = 1
    max_num_chunk: int = 10
    min_mapq: int = 2

    # DTW (RawAlign integration)
    dtw_border_constraint: DtwBorderConstraint = DtwBorderConstraint.SPARSE
    dtw_fill_method: DtwFillMethod = DtwFillMethod.BANDED
    dtw_band_radius_frac: float = 0.10
    dtw_match_bonus: float = 0.4
    dtw_min_score: float = 20.0

    # Sequence Until
    t_threshold: float = 1.5
    tn_samples: int = 5
    ttest_freq: int = 500
    tmin_reads: int = 500

    flag: MapFlag = MapFlag(0)
    mini_batch_size: int = 500_000_000

    # reverse-complement collision handling (parity fields)
    rev_col_limit: int = 100
    chn_rev_bump: float = 1.0

    # event detector options (mapping side)
    window_length1: int = 3
    window_length2: int = 9
    threshold1: float = 4.0
    threshold2: float = 3.5
    peak_height: float = 0.4

    # --- device-engine capacities (static shapes for XLA) ---
    # These do not exist in the reference (it allocates dynamically); they
    # bound the padded device arrays.  Overflow is counted and reported.
    max_events_per_chunk: int = 768  # events kept per chunk (~chunk/5 + headroom)
    max_seeds_per_chunk: int = 768
    max_anchors_per_read: int = 4096  # INITIAL anchor budget for the chaining DP
    # hard ceiling for the overflow-retry capacity growth (a chunk whose hit
    # count exceeds the live a_cap is re-run at doubled capacity — the
    # reference never truncates hits, rseed.c:105-154); 0 disables growth
    max_anchor_cap: int = 1 << 17
    batch_reads: int = 256  # reads mapped concurrently on device
    # multi-chip scale-out (net-new vs the reference, SURVEY.md §2.4): >0
    # activates the (dp, shard) mesh over all visible devices with the seed
    # table hash-range-sharded n_shards ways (1 = pure data parallelism)
    n_shards: int = 0
    pipeline_depth: int = 3  # read batches in flight (device/host overlap)

    @property
    def sample_per_base(self) -> float:
        return float(self.sample_rate) / float(self.bp_per_sec)


PRESET_NAMES = (
    "viral",
    "sensitive",
    "fast",
    "faster",
    "ava-viral",
    "ava",
    "ava-sensitive",
    "ava-large",
    "sequence-until",
)


def set_preset(preset: str | None, io: IndexOptions, mo: MapOptions) -> None:
    """Apply a `-x` preset (reference: ri_set_opt, src/main.cpp:111-210).

    Mutates `io`/`mo` in place; presets are applied before other flags,
    exactly as the reference's two-pass option parse does.
    """
    if preset is None:
        return
    if preset == "viral":
        io.e = 6
        mo.bw = 100
        mo.max_target_gap_length = 500
        mo.max_query_gap_length = 500
        mo.max_num_chunk = 5
        mo.min_chaining_score = 10
        mo.chain_gap_scale = 1.2
        mo.chain_skip_scale = 0.3
    elif preset in ("sensitive", "sequence-until"):
        pass  # defaults
    elif preset == "fast":
        io.fine_range = 0.6
        mo.min_mapq = 5
        mo.min_chaining_score = 10
        mo.chain_gap_scale = 0.6
    elif preset == "faster":
        io.e = 11
        io.w = 3
        io.fine_range = 0.6
        mo.max_num_chunk = 5
        mo.min_mapq = 5
        mo.min_chaining_score = 10
        mo.chain_gap_scale = 0.6
    elif preset == "ava-viral":
        io.e = 6
        mo.chain_gap_scale = 1.2
        mo.chain_skip_scale = 0.3
        io.w = 0
        io.diff = 0.45
        mo.min_chaining_score = 20
        mo.min_chaining_score2 = 30
        mo.min_num_anchors = 5
        mo.min_mapq = 5
        mo.bw = 1000
        mo.max_target_gap_length = 2500
        mo.max_query_gap_length = 2500
        io.flag |= IndexFlag.SIG_TARGET
        mo.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE
        mo.pri_ratio = 0.0
    elif preset == "ava":
        io.w = 3
        io.diff = 0.45
        mo.min_chaining_score = 40
        mo.min_chaining_score2 = 75
        mo.min_num_anchors = 5
        mo.min_mapq = 5
        mo.bw = 5000
        mo.max_target_gap_length = 2500
        mo.max_query_gap_length = 2500
        io.flag |= IndexFlag.SIG_TARGET
        mo.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE
        mo.pri_ratio = 0.0
    elif preset == "ava-sensitive":
        io.w = 0
        io.diff = 0.45
        mo.min_chaining_score = 75
        mo.min_chaining_score2 = 100
        mo.min_num_anchors = 5
        mo.min_mapq = 5
        mo.bw = 1000
        mo.max_target_gap_length = 2500
        mo.max_query_gap_length = 2500
        io.flag |= IndexFlag.SIG_TARGET
        mo.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE
        mo.pri_ratio = 0.0
    elif preset == "ava-large":
        io.fine_range = 0.6
        mo.chain_gap_scale = 0.6
        io.w = 5
        io.diff = 0.45
        mo.min_chaining_score = 20
        mo.min_chaining_score2 = 50
        mo.min_num_anchors = 2
        mo.min_mapq = 2
        mo.bw = 5000
        mo.max_target_gap_length = 2500
        mo.max_query_gap_length = 2500
        io.flag |= IndexFlag.SIG_TARGET
        mo.flag |= MapFlag.ALL_CHAINS | MapFlag.NO_ADAPTIVE
        mo.pri_ratio = 0.0
    else:
        raise ValueError(f"unknown preset {preset!r}; choose from {PRESET_NAMES}")


def apply_r10(io: IndexOptions, mo: MapOptions) -> None:
    """`--r10` switch (reference: src/main.cpp:396-408)."""
    io.k = 9
    io.window_length1, io.window_length2 = 3, 6
    io.threshold1, io.threshold2 = 6.5, 4.0
    io.peak_height = 0.2
    mo.window_length1, mo.window_length2 = 3, 6
    mo.threshold1, mo.threshold2 = 6.5, 4.0
    mo.peak_height = 0.2
    mo.chain_gap_scale = 1.2


def apply_depletion(mo: MapOptions) -> None:
    """`--depletion` switch (reference: src/main.cpp:363-366)."""
    mo.best_n = 5
    mo.min_mapq = 10
    mo.w_threshold = 0.50
    mo.min_num_anchors = 2
    mo.min_chaining_score = 15
    mo.chain_skip_scale = 0.0


def options_to_dict(opt) -> dict:
    d = dataclasses.asdict(opt)
    if "flag" in d:
        d["flag"] = int(d["flag"])
    return d
