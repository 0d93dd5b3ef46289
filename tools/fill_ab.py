"""A/B of the chain fill on the GPU: the Pallas kernel against the lax.scan.

Two measurements, both in this one process and both alternating the two
fills (kernel, scan, scan, kernel):

  * kernel only, at chip_smoke.py's phase-4 shapes (B=256, N in {3072,
    16384}, W=200, bw in {500, 5000}), for each num_warps in --warps;
  * end to end, over chip_smoke.py's viral and ecoli workloads mapped by one
    MappingEngine each, with the fill swapped through merge_sort_fill's
    `fill=` argument; each variant keeps its own compiled programs.

Both variants must give identical records.  Prints one line per timing and
writes everything to chiprun_out/fill_ab.json.

    python tools/fill_ab.py [--warps 1,2,4,8] [--reps 3]
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def kernel_only(card, warps, reps, out):
    import jax.numpy as jnp

    from rawhash_tpu.chain.device import chain_fill_batch
    from rawhash_tpu.chain.pallas_fill import chain_fill_pallas

    rng = np.random.default_rng(2026)
    for n in cs.KERNEL_NS:
        planes = cs.synthetic_anchors(rng, cs.KERNEL_B, n, 5_000_000)
        args = [jnp.asarray(x) for x in planes]
        cells = int(planes[3].sum()) * cs.KERNEL_W
        for bw in (500, 5000):
            kw = dict(q_span=13, max_dist_t=2500, max_dist_q=2500, bw=bw,
                      max_iter=cs.KERNEL_W, chn_pen_gap=0.104,
                      chn_pen_skip=0.0)
            fills = {"scan": functools.partial(chain_fill_batch, **kw)}
            for nw in warps:
                fills[f"kernel_w{nw}"] = functools.partial(
                    chain_fill_pallas, **kw, num_warps=nw
                )
            ref = [np.asarray(x) for x in fills["scan"](*args)]
            times = {k: [] for k in fills}
            order = list(fills) + list(reversed(fills))
            for _ in range(reps):
                for name in order:
                    got, t = cs.timed(fills[name], *args, reps=1)
                    times[name].append(t)
                    if name != "scan":
                        for a, b in zip(ref, got):
                            np.testing.assert_array_equal(a, np.asarray(b))
            row = {k: float(np.median(v)) for k, v in times.items()}
            out.append(dict(kind="kernel_only", n=n, bw=bw, cells=cells,
                            card=card, median_s=row))
            print(f"fill B={cs.KERNEL_B} N={n} bw={bw}: " + ", ".join(
                f"{k} {v * 1e3:.3f} ms" for k, v in row.items()
            ) + f" [{card}]", flush=True)


def end_to_end(card, reps, out):
    import rawhash_tpu.map.device_step as ds
    from rawhash_tpu.chain.device import chain_fill_batch
    from rawhash_tpu.chain.pallas_fill import chain_fill_pallas
    from rawhash_tpu.index.serialize import load_index

    fills = {"kernel": chain_fill_pallas, "scan": chain_fill_batch}
    base = ds.merge_sort_fill
    memos = (ds.chunk_step_aot, ds.chunk_step_tail_aot)
    programs = {k: [({}, {}) for _ in memos] for k in fills}

    def use(name):
        ds.merge_sort_fill = functools.partial(base, fill=fills[name])
        for memo, (cache, specs) in zip(memos, programs[name]):
            memo.cache, memo.specs = cache, specs

    fx = cs.make_fixtures(REPO / "smoke_out" / "fill_ab", [cs.VIRAL, cs.ECOLI])
    for wname in ("viral", "ecoli"):
        w = fx[wname]
        idx = w["dir"] / "ref.rhi.npz"
        cs.run_cli(["-x", w["preset"], "-p", fx["pore"], "-d", idx,
                    w["dir"] / "ref.fa"])
        engine = cs.engine_for(w, load_index(str(idx)))
        reads = [(n, s) for n, s, _, _ in w["reads"]]
        records = {}
        for name in ("kernel", "scan", "kernel"):  # warm both variants
            use(name)
            records[name] = cs.record_key(cs.map_all(engine, reads))
        assert records["kernel"] == records["scan"], wname
        times = {k: [] for k in fills}
        cells = {k: [] for k in fills}
        for _ in range(reps):
            for name in ("kernel", "scan", "scan", "kernel"):
                use(name)
                c0 = engine.stats.get("dp_cells", 0)
                t0 = time.perf_counter()
                got = cs.record_key(cs.map_all(engine, reads))
                times[name].append(time.perf_counter() - t0)
                cells[name].append(engine.stats.get("dp_cells", 0) - c0)
                assert got == records["kernel"], (wname, name)
        row = {k: float(np.median(v)) for k, v in times.items()}
        out.append(dict(kind="end_to_end", workload=wname, card=card,
                        reads=len(reads), median_s=row, all_s=times,
                        dp_cells=cells, device_tail_chunks=engine.stats.get(
                            "device_tail_chunks", 0)))
        print(f"end to end {wname} ({len(reads)} reads): kernel "
              f"{row['kernel']:.3f} s, scan {row['scan']:.3f} s per pass; "
              f"passes {times} [{card}]", flush=True)
    ds.merge_sort_fill = base


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warps", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    devs = cs.check_device(1)
    card = cs.nvidia_smi().splitlines()[0]
    out = []
    kernel_only(card, [int(x) for x in args.warps.split(",")], args.reps, out)
    end_to_end(card, args.reps, out)
    dest = REPO / "chiprun_out" / "fill_ab.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(
        {"device": devs[0].device_kind, "card": card, "rows": out}, indent=1))
    print(f"wrote {dest}")


if __name__ == "__main__":
    main()
