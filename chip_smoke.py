"""Smoke run of the mapping path on an NVIDIA GPU, through the CLI.

    python chip_smoke.py               # one card: phases 0-5
    python chip_smoke.py --four-cards  # the sharded index on four cards only

One card:
  0. device: JAX must find a GPU (no CPU fallback); prints the card, its
     power limit, the compile-cache directory and the native host library
  1. fixtures: genomes, a pore model and .sig.npz reads from fixed seeds
     (written to smoke_out/, which git ignores)
  2. viral (30 kb, preset viral, batch 256, 1,200 bp reads): index build and
     mapping through rawhash_tpu.cli.main; accuracy against the simulated
     truth; the PAF (columns 1-12) of 64 reads against the same CLI run in a
     child process pinned to the CPU
  3. ecoli (5 Mbp, preset sensitive, batch 256, 2,500 bp reads): the same;
     at least one chunk must run on the device tail, and device-tail records
     must equal host-tail records on the card
  4. kernels at real widths: the chain-fill kernel against the lax.scan
     fill (bit-exact), the lockstep backtrack against chain/host.py, their
     device times, and the chunk step's memory analysis
  5. the other user modes at small size: all-vs-all overlap (-x ava
     --sig-target) and DTW chain evaluation (--dtw-evaluate-chains)

Four cards: the ecoli workload on one card and with the seed table sharded
over four cards (n_shards 4: mesh 1x4; n_shards 2: mesh 2x2), on the host
tail and on the device tail; every sharded run must give the one-card
records.

Everything runs in this one process (the card is opened once); the CPU
reference of phase 2 runs in a child pinned to the CPU.  Any failure exits
non-zero.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "smoke_out"

# the deployments of bench.py's viral and ecoli cells
VIRAL = dict(name="viral", genome_len=30_000, preset="viral", n_reads=512,
             read_len=1200, max_anchors=3072, seed=7)
ECOLI = dict(name="ecoli", genome_len=5_000_000, preset="sensitive",
             n_reads=512, read_len=2500, max_anchors=16384, seed=11)
SMALL = dict(name="small", genome_len=8000, n_reads=6, read_len=600, seed=5)
BATCH = 256
N_COMPARE = 64  # reads compared against the CPU run / across the two tails
# GPU vs CPU PAF: XLA's GPU backend rounds f32 division, square root and
# fused multiply-adds differently from the CPU's IEEE operations, so a
# t-statistic at a peak threshold can move an event boundary.  Query-side
# coordinates (PAF columns 2, 3, 4, 10: events) may then differ by a few
# events; every other column must be identical.
QUERY_COLS, EVENT_TOL = (1, 2, 3, 9), 2
# phase 4: the engine's batch and anchor widths (a_cap + p_cap ladders),
# W = max_chain_iter
KERNEL_B, KERNEL_NS, KERNEL_W = 256, (3072, 16384), 200


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"[{name}] start")
    t0 = time.perf_counter()
    yield
    log(f"[{name}] wall {time.perf_counter() - t0:.2f} s")


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(args: list) -> str:
    """rawhash_tpu.cli.main in this process; returns what it logged."""
    from rawhash_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = main([str(a) for a in args])
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}")
    return buf.getvalue()


# ---------------------------------------------------------------- phase 0


def nvidia_smi() -> str:
    """Each card's name and power limit, one line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def check_device(n_cards: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke needs {n_cards} GPUs; JAX found {len(devs)}")
    smi = nvidia_smi()
    from rawhash_tpu._native import get_lib
    from rawhash_tpu.utils.xla_cache import enable_compile_cache

    log(f"device: {devs[0].device_kind} x{len(devs)}")
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    log(f"compile cache: {enable_compile_cache()}")
    log(f"native host library loaded: {get_lib() is not None}")
    return devs


# ---------------------------------------------------------------- phase 1


def make_workload(w: dict, pore, out: Path) -> dict:
    """Genome FASTA + .sig.npz reads (+ a first-N subset) with the truth."""
    from rawhash_tpu.io.sigfile import write_sig_npz
    from rawhash_tpu.io.signal_gen import simulate_reads

    rng = np.random.default_rng(w["seed"])
    genome = rng.integers(0, 4, w["genome_len"], dtype=np.uint8).choose(
        np.frombuffer(b"ACGT", np.uint8)
    ).tobytes().decode()
    d = out / w["name"]
    d.mkdir(parents=True, exist_ok=True)
    (d / "ref.fa").write_text(f">chr1\n{genome}\n")
    reads = simulate_reads(genome, pore, n_reads=w["n_reads"],
                           read_len=w["read_len"], rng=rng)
    write_sig_npz(str(d / "reads.sig.npz"), [(n, s) for n, s, _, _ in reads])
    write_sig_npz(str(d / "subset.sig.npz"),
                  [(n, s) for n, s, _, _ in reads[:N_COMPARE]])
    return dict(w, dir=d, reads=reads,
                truth={n: (st, sd) for n, _, st, sd in reads})


def write_pore_model(pore, path: Path) -> None:
    bases = "ACGT"
    with open(path, "w") as fp:
        fp.write("kmer\tlevel_mean\tlevel_stdv\n")
        for i, v in enumerate(pore.pore_vals):
            kmer = "".join(bases[(i >> (2 * (5 - j))) & 3] for j in range(6))
            fp.write(f"{kmer}\t{90 + 12 * v:.4f}\t2.0\n")


def make_fixtures(out: Path, workloads: list) -> dict:
    from rawhash_tpu.pore import synthetic_pore

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pore = synthetic_pore(k=6)
    write_pore_model(pore, out / "pore.model")
    fx = {"pore": out / "pore.model"}
    for w in workloads:
        fx[w["name"]] = make_workload(w, pore, out)
        log(f"fixtures: {w['name']}: {w['genome_len']} bp genome, "
            f"{w['n_reads']} reads of {w['read_len']} bp")
    return fx


# ------------------------------------------------------------ phases 2, 3


def paf_rows(path: Path) -> list:
    return [l.rstrip("\n").split("\t") for l in open(path) if l.strip()]


def score_paf(rows: list, w: dict) -> tuple:
    """(mapped fraction, accuracy of mapped) under bench.py's truth rule:
    the read's first record is correct if its target start lies within
    read_len + 500 of the true start on the true strand."""
    first = {}
    for r in rows:
        first.setdefault(r[0], r)
    n_mapped = n_correct = 0
    for name, (start, strand) in w["truth"].items():
        r = first[name]
        if r[5] == "*":
            continue
        n_mapped += 1
        if abs(int(r[7]) - start) < w["read_len"] + 500 and (r[4] == "-") == bool(strand):
            n_correct += 1
    return n_mapped / len(w["truth"]), n_correct / max(n_mapped, 1)


def map_args(w: dict, index) -> list:
    return ["-x", w["preset"], "--batch-reads", BATCH,
            "--max-anchors", w["max_anchors"], index]


def build_and_map(w: dict, fx: dict) -> str:
    d = w["dir"]
    run_cli(["-x", w["preset"], "-p", fx["pore"], "-d", d / "ref.rhi.npz",
             d / "ref.fa"])
    err = run_cli(map_args(w, d / "ref.rhi.npz")
                  + [d / "reads.sig.npz", "-o", d / "out.paf"])
    mapped, acc = score_paf(paf_rows(d / "out.paf"), w)
    log(f"{w['name']}: mapped {mapped:.3f} of {w['n_reads']} reads, "
        f"accuracy of mapped {acc:.3f}")
    if mapped < 0.5 or acc < 0.9:
        raise AssertionError(f"{w['name']}: mapped {mapped}, accuracy {acc}")
    return err


def start_cpu_reference(w: dict) -> subprocess.Popen:
    """The same CLI run on the first reads, in a child pinned to the CPU."""
    d = w["dir"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "rawhash_tpu",
         *map(str, map_args(w, d / "ref.rhi.npz")),
         str(d / "subset.sig.npz"), "-o", str(d / "subset_cpu.paf")],
        env=env, cwd=str(REPO), stdout=subprocess.DEVNULL,
        stderr=open(d / "subset_cpu.log", "w"),
    )


def compare_with_cpu(w: dict, child: subprocess.Popen) -> None:
    d = w["dir"]
    run_cli(map_args(w, d / "ref.rhi.npz")
            + [d / "subset.sig.npz", "-o", d / "subset_gpu.paf"])
    if child.wait(timeout=900) != 0:
        raise RuntimeError(f"CPU reference failed: see {d / 'subset_cpu.log'}")
    gpu = [r[:12] for r in paf_rows(d / "subset_gpu.paf")]
    cpu = [r[:12] for r in paf_rows(d / "subset_cpu.paf")]
    same = sum(g == c for g, c in zip(gpu, cpu))
    log(f"{w['name']}: GPU vs CPU PAF (cols 1-12): {same}/{len(cpu)} lines "
        f"identical ({len(gpu)} GPU lines)")
    ok = len(gpu) == len(cpu)
    for g, c in zip(gpu, cpu):
        if g == c:
            continue
        log(f"  gpu: {' '.join(g)}\n  cpu: {' '.join(c)}")
        ok &= all(
            g[i] == c[i] or (
                i in QUERY_COLS and g[i].isdigit() and c[i].isdigit()
                and abs(int(g[i]) - int(c[i])) <= EVENT_TOL
            )
            for i in range(12)
        )
    if not ok:
        raise AssertionError(
            f"{w['name']}: GPU PAF differs from the CPU's beyond "
            f"{EVENT_TOL} events on the query side"
        )


def record_key(results) -> list:
    return [(r.name, [(m.mapped, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.rev, m.mapq)
                      for m in r.records]) for r in results]


@contextlib.contextmanager
def tail_mode(device_tail: bool):
    var = "RAWHASH_TPU_DEVICE_TAIL" if device_tail else "RAWHASH_TPU_NO_DEVICE_TAIL"
    os.environ[var] = "1"
    try:
        yield
    finally:
        del os.environ[var]


def engine_for(w: dict, index, n_shards: int = 0):
    from rawhash_tpu.cli import build_parser, options_from_args
    from rawhash_tpu.map.engine import MappingEngine

    args = build_parser().parse_args(
        [str(a) for a in map_args(w, "x")] + ["--n-shards", str(n_shards)]
    )
    return MappingEngine(index, options_from_args(args)[1])


def map_all(engine, reads: list) -> list:
    batches = [reads[i:i + BATCH] for i in range(0, len(reads), BATCH)]
    return [r for res in engine.map_stream(batches) for r in res]


def compare_tails(w: dict) -> None:
    """Device-tail records == host-tail records, both on the card."""
    from rawhash_tpu.index.serialize import load_index

    index = load_index(str(w["dir"] / "ref.rhi.npz"))
    reads = [(n, s) for n, s, _, _ in w["reads"][:N_COMPARE]]
    out = {}
    for dev in (True, False):
        with tail_mode(dev):
            eng = engine_for(w, index)
            assert eng.device_tail == dev
            t0 = time.perf_counter()
            out[dev] = record_key(eng.map_batch(reads))
            log(f"{w['name']}: {'device' if dev else 'host'} tail on "
                f"{len(reads)} reads: {time.perf_counter() - t0:.2f} s "
                "(compile included)")
    n_mapped = sum(m[0] for _, recs in out[True] for m in recs[:1])
    if out[True] != out[False]:
        raise AssertionError(f"{w['name']}: device-tail records differ")
    log(f"{w['name']}: device-tail records == host-tail records "
        f"({len(reads)} reads, {n_mapped} mapped)")


# ---------------------------------------------------------------- phase 4


def synthetic_anchors(rng, b: int, n: int, genome_len: int):
    """Sorted anchor planes with chain structure: diagonal runs of 3-25
    anchors on both strands plus 30% noise, n/2..n live anchors per read."""
    key = np.zeros((b, n), np.uint32)
    tpos = np.full((b, n), 0x7FFFFFFF, np.int32)
    qpos = np.zeros((b, n), np.int32)
    n_live = rng.integers(n // 2, n + 1, b).astype(np.int32)
    for i in range(b):
        m = int(n_live[i])
        runs = rng.integers(3, 26, m)
        run_of = np.repeat(np.arange(m), runs)[:m]
        k0 = rng.integers(0, 2, m).astype(np.uint32) << np.uint32(31)
        t0 = rng.integers(0, genome_len, m)
        q0 = rng.integers(0, 2000, m)
        first = np.searchsorted(run_of, run_of)  # index of each run's start
        step = np.cumsum(rng.integers(5, 40, m))
        off = step - step[first]
        k = k0[run_of]
        t = t0[run_of] + off
        q = q0[run_of] + off + rng.integers(-3, 4, m)
        noise = rng.random(m) < 0.3
        t[noise] = rng.integers(0, genome_len, int(noise.sum()))
        q[noise] = rng.integers(0, 2000, int(noise.sum()))
        order = np.lexsort((t, k))
        key[i, :m], tpos[i, :m] = k[order], t[order]
        qpos[i, :m] = np.clip(q[order], 0, None)
    return key, tpos, qpos, n_live


def timed(fn, *args, reps: int = 3):
    """(output, median seconds) of a jitted call, compile excluded."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def check_kernels(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from rawhash_tpu.chain.backtrack_device import backtrack_batch, compact_batch
    from rawhash_tpu.chain.device import chain_fill_batch
    from rawhash_tpu.chain.host import chain_backtrack
    from rawhash_tpu.chain.pallas_fill import chain_fill_pallas

    rng = np.random.default_rng(2026)
    b, w = KERNEL_B, KERNEL_W
    for n in KERNEL_NS:
        planes = synthetic_anchors(rng, b, n, 5_000_000)
        args = [jnp.asarray(x) for x in planes]
        for bw in (5000, 500):
            kw = dict(q_span=13, max_dist_t=2500, max_dist_q=2500, bw=bw,
                      max_iter=w, chn_pen_gap=0.104, chn_pen_skip=0.0)
            (f0, p0), t_scan = timed(functools.partial(chain_fill_batch, **kw), *args)
            (f1, p1), t_kern = timed(functools.partial(chain_fill_pallas, **kw), *args)
            np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))
            np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
            cells = int(planes[3].sum()) * w
            log(f"fill B={b} N={n} W={w} bw={bw}: kernel == scan (f, p "
                f"bit-exact); kernel {t_kern * 1e3:.3f} ms, scan "
                f"{t_scan * 1e3:.3f} ms, {cells / t_kern / 1e9:.2f} G "
                f"cells/s kernel [{card}]")
    # the widest n and bw 500 from here: the ecoli-width device tail
    bt = dict(min_cnt=2, min_sc=15, max_drop=500, k_cap=4096)
    na = args[3]
    (u_sc, u_cnt, n_u, v, n_v, ovf), t_bt = timed(
        jax.jit(functools.partial(backtrack_batch, **bt)), f0, p0, na
    )
    (_, _, summaries), t_cp = timed(
        jax.jit(functools.partial(compact_batch, q_span=13)),
        u_sc, u_cnt, n_u, v, n_v, *args[:3],
    )
    assert int(np.asarray(ovf).max()) == 0
    hf, hp = np.asarray(f0), np.asarray(p0)
    rows = rng.choice(b, min(8, b), replace=False)
    for i in rows:
        nl = int(planes[3][i])
        u, hv = chain_backtrack(hf[i, :nl].astype(np.int32),
                                hp[i, :nl].astype(np.int64),
                                min_cnt=2, min_sc=15, max_drop=500)
        k = int(np.asarray(n_u)[i])
        assert k == u.shape[0] and k > 0, (i, k, u.shape)
        np.testing.assert_array_equal(np.asarray(u_sc)[i, :k], u[:, 0])
        np.testing.assert_array_equal(np.asarray(u_cnt)[i, :k], u[:, 1])
        np.testing.assert_array_equal(np.asarray(v)[i, : int(np.asarray(n_v)[i])], hv)
    log(f"backtrack B={b} N={n}: lockstep == chain/host.py on rows "
        f"{sorted(rows.tolist())}; backtrack {t_bt * 1e3:.3f} ms, compaction "
        f"{t_cp * 1e3:.3f} ms [{card}]")


def report_memory() -> None:
    import jax

    from rawhash_tpu.map.device_step import chunk_step_aot, chunk_step_tail_aot

    for memo in (chunk_step_tail_aot, chunk_step_aot):
        if not memo.specs:
            continue
        key = max(memo.specs, key=lambda k: sum(
            int(np.prod(s)) for s, _ in k[0]))
        spec = memo.specs[key]
        ma = memo.cache[key].lower(*spec).compile().memory_analysis()
        log(f"{memo.raw.__name__} (widest signature) memory analysis: {ma}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------- phase 5


def other_modes(fx: dict) -> None:
    w = fx["small"]
    d = w["dir"]
    reads = d / "reads.sig.npz"
    run_cli(["-x", "ava", "--sig-target", "-d", d / "ava.rhi.npz", reads])
    run_cli(["-x", "ava", d / "ava.rhi.npz", reads, "-o", d / "ava.paf"])
    rows = paf_rows(d / "ava.paf")
    assert {r[0] for r in rows} == set(w["truth"]), "ava: reads missing"
    log(f"ava: {sum(r[5] != '*' for r in rows)} overlaps among "
        f"{w['n_reads']} reads")
    run_cli(["-x", "sensitive", "-p", fx["pore"], "--store-sig",
             "-d", d / "dtw.rhi.npz", d / "ref.fa"])
    run_cli(["-x", "sensitive", "--dtw-evaluate-chains", "--max-anchors",
             512, d / "dtw.rhi.npz", reads, "-o", d / "dtw.paf"])
    mapped, acc = score_paf(paf_rows(d / "dtw.paf"), w)
    log(f"dtw: mapped {mapped:.3f}, accuracy of mapped {acc:.3f}")
    assert mapped > 0 and acc >= 0.8, (mapped, acc)


# ------------------------------------------------------------------ drivers


def one_card() -> list:
    with phase("phase 0 device"):
        devs = check_device(1)
        card = nvidia_smi().splitlines()[0]
    with phase("phase 1 fixtures"):
        fx = make_fixtures(OUT, [VIRAL, ECOLI, SMALL])
    with phase("phase 2 viral"):
        w = fx["viral"]
        # the child needs the index: build it first, then overlap the CPU
        # run with the GPU run
        build_and_map(w, fx)
        child = start_cpu_reference(w)
        compare_with_cpu(w, child)
    with phase("phase 3 ecoli"):
        w = fx["ecoli"]
        err = build_and_map(w, fx)
        tail_line = [l for l in err.splitlines() if "chunks on the device tail" in l]
        n_tail = int(tail_line[-1].split("; ")[-1].split()[0])
        log(f"ecoli: {n_tail} chunks ran on the device tail")
        assert n_tail >= 1, "ecoli never switched to the device tail"
        compare_tails(w)
    with phase("phase 4 kernels"):
        check_kernels(card)
        report_memory()
    with phase("phase 5 other modes"):
        other_modes(fx)
    return devs


def four_cards() -> list:
    with phase("phase 0 device"):
        devs = check_device(4)
    with phase("phase 1 fixtures"):
        fx = make_fixtures(OUT, [ECOLI])
        w = fx["ecoli"]
        run_cli(["-x", w["preset"], "-p", fx["pore"], "-d",
                 w["dir"] / "ref.rhi.npz", w["dir"] / "ref.fa"])
    from rawhash_tpu.index.serialize import load_index

    index = load_index(str(w["dir"] / "ref.rhi.npz"))
    reads = [(n, s) for n, s, _, _ in w["reads"]]
    for dev in (False, True):
        tail = "device" if dev else "host"
        with phase(f"sharded {tail} tail"), tail_mode(dev):
            ref = None
            for n_shards in (0, 4, 2):
                eng = engine_for(w, index, n_shards)
                assert eng.device_tail == dev
                mesh = dict(eng.dist.mesh.shape) if eng.dist else "one card"
                t0 = time.perf_counter()
                got = record_key(map_all(eng, reads))
                log(f"ecoli {tail} tail, n_shards={n_shards} ({mesh}): "
                    f"{len(reads)} reads in {time.perf_counter() - t0:.2f} s "
                    "(compile included)")
                if ref is None:
                    ref = got
                    n_mapped = sum(recs[0][0] for _, recs in got)
                    assert n_mapped > len(reads) // 2, n_mapped
                elif got != ref:
                    raise AssertionError(
                        f"{tail} tail, n_shards={n_shards}: records differ "
                        "from the one-card run"
                    )
            log(f"ecoli {tail} tail: n_shards 4 and 2 == one card "
                f"({len(reads)} reads, {n_mapped} mapped)")
        del eng
    return devs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded index on four cards")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    devs = four_cards() if args.four_cards else one_card()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
