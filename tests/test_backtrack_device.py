"""Device backtrack/compaction == host oracle (chain/host.py).

Runs the real chain fill on simulated anchor sets, then checks the batched
while-loop backtrack (chain/backtrack_device.py) reproduces chain scores,
counts, claimed-anchor order, target-sorted chain order, coordinates and
fuzzy lengths exactly (reference: mg_chain_backtrack lchain.c:95-194 +
compact_a lchain.c:214-281 + mm_cal_fuzzy_len hit.c:10-40).
"""

import numpy as np
import pytest

from rawhash_tpu.chain.backtrack_device import backtrack_compact
from rawhash_tpu.chain.device import chain_fill_batch
from rawhash_tpu.chain.host import chain_backtrack, compact_chains

SPAN = 13
RI_ID_SHIFT = 32


def _pack(key, tpos, qpos):
    key = key.astype(np.uint64)
    ax = ((key >> np.uint64(31)) << np.uint64(63)) | (
        (key & np.uint64(0x7FFFFFFF)) << np.uint64(32)
    ) | tpos.astype(np.uint64)
    ay = (np.uint64(SPAN) << np.uint64(RI_ID_SHIFT)) | qpos.astype(np.uint64)
    return ax, ay


def _random_anchors(rng, n_live, n_cap, clustered=True):
    """Sorted anchors with chain structure: a few diagonal runs + noise."""
    key = np.zeros(n_cap, dtype=np.uint32)
    tpos = np.full(n_cap, 0x7FFFFFFF, dtype=np.int32)
    qpos = np.zeros(n_cap, dtype=np.int32)
    ks, ts, qs = [], [], []
    m = 0
    while m < n_live:
        run = int(rng.integers(3, 25)) if clustered else 1
        run = min(run, n_live - m)
        k0 = rng.integers(0, 3, dtype=np.uint32) | (
            np.uint32(rng.integers(0, 2)) << np.uint32(31)
        )
        t0 = int(rng.integers(0, 5000))
        q0 = int(rng.integers(0, 800))
        step = rng.integers(5, 40, size=run)
        jit = rng.integers(-3, 4, size=run)
        ks.extend([k0] * run)
        ts.extend((t0 + np.cumsum(step)).tolist())
        qs.extend((q0 + np.cumsum(step + jit)).tolist())
        m += run
    ks = np.asarray(ks, dtype=np.uint32)
    ts = np.asarray(ts, dtype=np.int32)
    qs = np.clip(np.asarray(qs, dtype=np.int32), 0, None)
    order = np.lexsort((ts, ks))
    key[:n_live], tpos[:n_live], qpos[:n_live] = ks[order], ts[order], qs[order]
    return key, tpos, qpos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backtrack_matches_host(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    b, n_cap = 5, 256
    n_live = rng.integers(20, n_cap, size=b)
    keys = np.zeros((b, n_cap), np.uint32)
    tposs = np.zeros((b, n_cap), np.int32)
    qposs = np.zeros((b, n_cap), np.int32)
    for i in range(b):
        keys[i], tposs[i], qposs[i] = _random_anchors(rng, int(n_live[i]), n_cap)

    f, p = chain_fill_batch(
        jnp.asarray(keys), jnp.asarray(tposs), jnp.asarray(qposs),
        jnp.asarray(n_live.astype(np.int32)),
        q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=64,
        chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    min_cnt, min_sc, max_drop, k_cap = 2, 20, 500, 64
    summaries, n_u, asc, n_v, ovf = backtrack_compact(
        f, p, jnp.asarray(n_live.astype(np.int32)),
        jnp.asarray(keys), jnp.asarray(tposs), jnp.asarray(qposs),
        min_cnt=min_cnt, min_sc=min_sc, max_drop=max_drop, k_cap=k_cap,
        q_span=SPAN,
    )
    summaries = np.asarray(summaries)
    n_u = np.asarray(n_u)
    asc = np.asarray(asc)
    n_v = np.asarray(n_v)
    fh, ph = np.asarray(f), np.asarray(p)

    any_chain = False
    for i in range(b):
        nl = int(n_live[i])
        ax, ay = _pack(keys[i, :nl], tposs[i, :nl], qposs[i, :nl])
        u, v = chain_backtrack(
            fh[i, :nl].astype(np.int32), ph[i, :nl].astype(np.int64),
            min_cnt=min_cnt, min_sc=min_sc, max_drop=max_drop,
        )
        u_s, bx, by, px, py = compact_chains(u, v, ax, ay)
        assert int(n_u[i]) == u.shape[0]
        assert int(ovf[i]) == 0
        any_chain = any_chain or u.shape[0] > 0
        # carried anchors: chain-major discovery order, ascending per chain
        nv = int(n_v[i])
        assert nv == px.shape[0]
        dev_px, dev_py = _pack(
            keys[i, asc[i, :nv]], tposs[i, asc[i, :nv]], qposs[i, asc[i, :nv]]
        )
        assert np.array_equal(dev_px, px)
        assert np.array_equal(dev_py, py)
        # summaries in target-sorted chain order
        s = summaries[i]
        nu = int(n_u[i])
        assert np.array_equal(s[:nu, 0], u_s[:, 0])
        assert np.array_equal(s[:nu, 1], u_s[:, 1])
        assert not s[nu:, 9].any()
        # per-chain first/last anchors + fuzzy lengths vs the host arrays
        cstarts = np.concatenate([[0], np.cumsum(u_s[:, 1])[:-1]]).astype(int)
        clasts = cstarts + u_s[:, 1].astype(int) - 1
        for c in range(nu):
            x0, xl = bx[cstarts[c]], bx[clasts[c]]
            y0, yl = by[cstarts[c]], by[clasts[c]]
            key_bits = np.uint32(s[c, 2])
            assert ((x0 >> np.uint64(63)) << np.uint64(31)) | (
                (x0 >> np.uint64(32)) & np.uint64(0x7FFFFFFF)
            ) == key_bits
            assert int(x0 & np.uint64(0xFFFFFFFF)) == s[c, 3]
            assert int(y0 & np.uint64(0xFFFFFFFF)) == s[c, 4]
            assert int(xl & np.uint64(0xFFFFFFFF)) == s[c, 5]
            assert int(yl & np.uint64(0xFFFFFFFF)) == s[c, 6]
        # mlen/blen vs regions oracle
        if nu:
            from rawhash_tpu.chain.regions import gen_regs

            regs = gen_regs(0, nu, u_s, bx, by)
            by_start = {r.as_: r for r in regs}
            for c in range(nu):
                r = by_start[cstarts[c]]
                assert r.mlen == s[c, 7], (c, r.mlen, s[c, 7])
                assert r.blen == s[c, 8]
    assert any_chain  # fixtures must actually produce chains


def test_chain_overflow_counts():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    b, n_cap = 2, 256
    keys = np.zeros((b, n_cap), np.uint32)
    tposs = np.zeros((b, n_cap), np.int32)
    qposs = np.zeros((b, n_cap), np.int32)
    for i in range(b):
        keys[i], tposs[i], qposs[i] = _random_anchors(rng, n_cap, n_cap)
    n_live = np.full(b, n_cap, np.int32)
    f, p = chain_fill_batch(
        jnp.asarray(keys), jnp.asarray(tposs), jnp.asarray(qposs),
        jnp.asarray(n_live),
        q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=64,
        chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    _, n_u_big, _, _, ovf_big = backtrack_compact(
        f, p, jnp.asarray(n_live), jnp.asarray(keys), jnp.asarray(tposs),
        jnp.asarray(qposs),
        min_cnt=2, min_sc=20, max_drop=500, k_cap=64, q_span=SPAN,
    )
    _, n_u_small, _, _, ovf_small = backtrack_compact(
        f, p, jnp.asarray(n_live), jnp.asarray(keys), jnp.asarray(tposs),
        jnp.asarray(qposs),
        min_cnt=2, min_sc=20, max_drop=500, k_cap=1, q_span=SPAN,
    )
    n_chains = int(np.asarray(n_u_big).max())
    if n_chains > 1:
        assert int(np.asarray(ovf_small).max()) > 0
    assert int(np.asarray(ovf_big).max()) == 0


def _fill_rows(rng, b, n_cap, n_live):
    import jax.numpy as jnp

    keys = np.zeros((b, n_cap), np.uint32)
    tposs = np.zeros((b, n_cap), np.int32)
    qposs = np.zeros((b, n_cap), np.int32)
    for i in range(b):
        keys[i], tposs[i], qposs[i] = _random_anchors(rng, int(n_live[i]), n_cap)
    na = jnp.asarray(np.asarray(n_live, np.int32))
    f, p = chain_fill_batch(
        jnp.asarray(keys), jnp.asarray(tposs), jnp.asarray(qposs), na,
        q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=200,
        chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    return f, p, na


@pytest.mark.parametrize("n_cap,seed", [(1024, 0), (1024, 1), (4096, 2), (4096, 3)])
def test_backtrack_batch_matches_host_wide(n_cap, seed):
    """The lockstep backtrack (the device tail on every platform) equals
    mg_chain_backtrack at wide anchor widths: chain scores, counts and the
    claimed-anchor order (lchain.c:95-194)."""
    from rawhash_tpu.chain.backtrack_device import backtrack_batch

    rng = np.random.default_rng(seed)
    b = 3
    n_live = rng.integers(n_cap // 2, n_cap + 1, size=b)
    f, p, na = _fill_rows(rng, b, n_cap, n_live)
    kw = dict(min_cnt=2, min_sc=20, max_drop=500)
    u_sc, u_cnt, n_u, v, n_v, ovf = (
        np.asarray(x) for x in backtrack_batch(f, p, na, **kw, k_cap=256)
    )
    fh, ph = np.asarray(f), np.asarray(p)
    for i in range(b):
        nl = int(n_live[i])
        u, hv = chain_backtrack(
            fh[i, :nl].astype(np.int32), ph[i, :nl].astype(np.int64), **kw
        )
        assert u.shape[0] > 1
        assert int(n_u[i]) == u.shape[0] and int(ovf[i]) == 0
        assert np.array_equal(u_sc[i, : n_u[i]], u[:, 0])
        assert np.array_equal(u_cnt[i, : n_u[i]], u[:, 1])
        assert np.array_equal(v[i, : n_v[i]], hv)


@pytest.mark.parametrize("seed", [4, 5])
def test_backtrack_batch_k_cap_overflow(seed):
    """k_cap=1: the first chain matches the host's, every later accepted
    chain is counted as overflow, and its claims are released."""
    from rawhash_tpu.chain.backtrack_device import backtrack_batch

    rng = np.random.default_rng(seed)
    b, n_cap = 2, 1024
    f, p, na = _fill_rows(rng, b, n_cap, np.full(b, n_cap))
    kw = dict(min_cnt=2, min_sc=20, max_drop=500)
    u_sc, u_cnt, n_u, v, n_v, ovf = (
        np.asarray(x) for x in backtrack_batch(f, p, na, **kw, k_cap=1)
    )
    fh, ph = np.asarray(f), np.asarray(p)
    for i in range(b):
        u, hv = chain_backtrack(
            fh[i].astype(np.int32), ph[i].astype(np.int64), **kw
        )
        assert u.shape[0] > 1
        assert int(n_u[i]) == 1 and int(ovf[i]) == u.shape[0] - 1
        assert (u_sc[i, 0], u_cnt[i, 0]) == (u[0, 0], u[0, 1])
        assert np.array_equal(v[i, : n_v[i]], hv[: u[0, 1]])
