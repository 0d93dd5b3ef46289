"""Sharded-engine scaling curve on the virtual CPU mesh.

Maps a fixed workload with the (dp, shard) mesh at 1/2/4/8 virtual devices
(one subprocess each — the device count is fixed at backend init) and
reports steady-state wall clock, parallel efficiency vs 1 device, and the
per-shard seed-hit balance.

Every process pins itself to the CPU, so the tool never opens a GPU.
Reading the numbers: all virtual devices share this host's cores, so wall
clock CANNOT improve with device count here — the curve measures the
partition + collective + dispatch OVERHEAD the mesh adds at fixed total
work (perfect scaling on real hardware would show as flat wall here iff
overhead were zero).

Usage: python tools/profiling/dist_scaling.py [--out dist_scaling.json]
Child mode (internal): ... --child N_DEV
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def child(n_dev: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= n_dev, (len(jax.devices()), n_dev)

    from rawhash_tpu.config import IndexOptions, MapOptions
    from rawhash_tpu.index.build import build_index_from_sequences
    from rawhash_tpu.io.signal_gen import simulate_reads
    from rawhash_tpu.map.engine import MappingEngine
    from rawhash_tpu.pore import synthetic_pore

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=200_000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    reads = simulate_reads(genome, pore, n_reads=32, read_len=2000,
                           rng=np.random.default_rng(5))
    batch = [(n, s) for n, s, _, _ in reads]

    mopt = MapOptions()
    mopt.n_shards = min(2, n_dev)
    engine = MappingEngine(index, mopt)
    if n_dev == 1:
        assert engine.dist.n_devices == 1
    engine.map_batch(list(batch))  # warmup (compiles)
    t0 = time.perf_counter()
    passes = 3
    mapped = 0
    for _ in range(passes):
        res = engine.map_batch(list(batch))
        mapped = sum(1 for r in res for m in r.records if m.mapped)
    dt = (time.perf_counter() - t0) / passes
    sh = engine.stats.get("shard_hits")
    out = {
        "n_devices": n_dev,
        "mesh": dict(engine.dist.mesh.shape),
        "wall_s_per_pass": round(dt, 3),
        "reads": len(batch),
        "mapped": mapped,
        "shard_hits": None if sh is None else [int(x) for x in sh],
    }
    print("CHILD_JSON " + json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dist_scaling.json")
    ap.add_argument("--child", type=int, default=0)
    ap.add_argument("--devices", default="1,2,4,8")
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return

    rows = []
    for n in [int(x) for x in args.devices.split(",")]:
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n}"
        ).strip()
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, "-u", __file__, "--child", str(n)],
            capture_output=True, text=True, timeout=1800, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        line = [l for l in r.stdout.splitlines() if l.startswith("CHILD_JSON ")]
        if not line:
            print(f"n={n} FAILED:\n{r.stderr[-2000:]}", file=sys.stderr)
            continue
        row = json.loads(line[-1][len("CHILD_JSON "):])
        rows.append(row)
        print(f"n={n}: {row['wall_s_per_pass']}s/pass mesh={row['mesh']} "
              f"mapped={row['mapped']}/{row['reads']} "
              f"shard_hits={row['shard_hits']}")

    if rows and rows[0]["n_devices"] == 1:
        base = rows[0]["wall_s_per_pass"]
        for row in rows:
            # overhead factor at fixed work on shared cores (see module doc)
            row["wall_vs_1dev"] = round(row["wall_s_per_pass"] / base, 3)
            if row["shard_hits"]:
                sh = np.asarray(row["shard_hits"], dtype=np.float64)
                n_sh = row["mesh"].get("shard", 1)
                per_shard = sh.reshape(-1, n_sh).sum(axis=0)
                tot = per_shard.sum()
                row["shard_balance"] = (
                    round(float(per_shard.min() / per_shard.max()), 3)
                    if tot > 0 and per_shard.max() > 0 else None
                )
    result = {
        "workload": "200 kbp genome, 32 reads x 2000 samples, 3 passes",
        "note": ("virtual CPU mesh on shared cores: wall_vs_1dev is the "
                 "mesh-software overhead factor at fixed work, NOT hardware "
                 "scaling; shard_balance = min/max per-shard owned hits"),
        "rows": rows,
    }
    with open(args.out, "w") as fp:
        json.dump(result, fp, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
