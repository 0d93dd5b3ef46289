"""Multi-host scale-out: jax.distributed runtime + process-spanning mesh.

Net-new vs the reference (it is strictly single-node pthreads, SURVEY.md
§2.4).  One process per host calls `initialize()`; the (dp, shard) mesh from
parallel/dist.py then spans every host's devices, the sharded seed table is
materialized with each process providing only its addressable shards, and
the same all_gather/psum_scatter seed merge rides NVLink within a host and
the network across hosts — XLA places the collectives, the mapping code is unchanged.

Run a worker (one per host):

    python -m rawhash_tpu.parallel.multihost \
        --coordinator HOST0:PORT --num-processes N --process-id I --selftest

`--selftest` maps a deterministic toy workload through the distributed chunk
step and checks the merged scalar outputs against the single-device step
computed locally, printing MULTIHOST_OK on success (exercised by
tests/test_multihost.py with two CPU processes).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def initialize(coordinator_address: str, num_processes: int, process_id: int):
    """Bring up the jax.distributed runtime (idempotent per process)."""
    import jax

    jax.distributed.initialize(
        coordinator_address, num_processes=num_processes, process_id=process_id
    )


def selftest(n_shards: int = 2) -> bool:
    """One distributed chunk step over the global mesh vs the local
    single-device step; returns True when the merged outputs agree."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from ..config import IndexOptions
    from ..index.build import build_index_from_sequences
    from ..index.device import DeviceIndex
    from ..map.device_step import chunk_step
    from ..pore import synthetic_pore
    from ..signal.events import NormCarry
    from .dist import DistContext, make_mesh

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())

    mesh = make_mesh(None, n_shards)
    ctx = DistContext(index, mesh)
    b = ctx.pad_batch(max(4, mesh.devices.size))
    l_chunk = 1024
    sig = rng.normal(90.0, 10.0, size=(b, l_chunk)).astype(np.float32)
    p_cap = 32
    pack = np.zeros((b, 3 * p_cap + 2), dtype=np.int32)
    pack[:, 3 * p_cap + 1] = l_chunk
    params = dict(
        diff=0.35, w=0, e=8, q=4, k=6,
        fine_min=-2.0, fine_max=2.0, fine_range=0.4,
        window_length1=3, window_length2=9,
        threshold1=4.0, threshold2=3.5, peak_height=0.4,
        e_cap=256, a_cap=256, min_events=5, mid_occ=100,
        max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=64,
        chn_pen_gap=0.104, chn_pen_skip=0.0,
        all_vs_all=False, keep_events=False, key_words=4, pos_bits=0,
    )
    out = ctx.step(
        sig, NormCarry.zeros(b), np.zeros(b, np.int32), pack,
        np.zeros(b, np.int32), np.zeros(max(1, index.n_seq), np.int32),
        **params,
    )
    got_scalars = np.asarray(
        multihost_utils.process_allgather(out.scalars, tiled=True)
    )
    got_packed = np.asarray(
        multihost_utils.process_allgather(out.packed, tiled=True)
    )

    # local single-device oracle on this process's default device
    didx = DeviceIndex.from_host(index)
    ref = chunk_step(
        didx, jnp.asarray(sig), NormCarry.zeros(b),
        jnp.zeros(b, jnp.int32), jnp.asarray(pack),
        jnp.zeros(b, jnp.int32), jnp.zeros(max(1, index.n_seq), jnp.int32),
        **params,
    )
    ok = bool(
        np.array_equal(got_scalars, np.asarray(ref.scalars))
        and np.array_equal(got_packed, np.asarray(ref.packed))
    )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rawhash-tpu-multihost")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--n-shards", type=int, default=2)
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    initialize(args.coordinator, args.num_processes, args.process_id)
    import jax

    print(
        f"[multihost] process {jax.process_index()}/{jax.process_count()}: "
        f"{jax.local_device_count()} local / {jax.device_count()} global devices",
        file=sys.stderr,
    )
    if args.selftest:
        if selftest(args.n_shards):
            print(f"MULTIHOST_OK process={args.process_id}")
            return 0
        print(f"MULTIHOST_MISMATCH process={args.process_id}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
