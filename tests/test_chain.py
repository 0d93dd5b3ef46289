import numpy as np
import pytest

from rawhash_tpu.chain.host import (
    chain_backtrack,
    compact_chains,
    lchain_dp_fill_np,
    lchain_dp_np,
    mg_log2,
)
from rawhash_tpu.chain.regions import gen_regs, select_sub, set_mapq, set_parent

RI_ID_SHIFT = 32
SPAN = 13  # k=6, e=8


def pack_anchors(rev, tid, tpos, qpos, span=SPAN):
    ax = (
        (np.asarray(rev, dtype=np.uint64) << np.uint64(63))
        | (np.asarray(tid, dtype=np.uint64) << np.uint64(32))
        | np.asarray(tpos, dtype=np.uint64)
    )
    ay = (np.uint64(span) << np.uint64(32)) | np.asarray(qpos, dtype=np.uint64)
    order = np.argsort(ax, kind="stable")
    return ax[order], ay[order]


def synthetic_anchors(rng, n_true=80, n_noise=60, tid=0, t0=5000):
    qpos = np.sort(rng.choice(np.arange(20, 1500), size=n_true, replace=False))
    tpos = t0 + qpos + rng.integers(-3, 4, size=n_true)
    rev = np.zeros(n_true, dtype=np.uint64)
    # noise anchors on another target
    qn = rng.integers(0, 1500, size=n_noise)
    tn = rng.integers(0, 100000, size=n_noise)
    return pack_anchors(
        np.concatenate([rev, np.zeros(n_noise, dtype=np.uint64)]),
        np.concatenate([np.zeros(n_true, dtype=np.uint64), np.ones(n_noise, dtype=np.uint64)]),
        np.concatenate([tpos, tn]).astype(np.uint64),
        np.concatenate([qpos, qn]).astype(np.uint64),
    )


def test_mg_log2_reference_poly():
    # spot values of the bit-twiddle approximation (must be the approx, not log2)
    assert abs(mg_log2(2.0) - 1.0) < 0.01
    assert abs(mg_log2(1024.0) - 10.0) < 0.01
    assert abs(mg_log2(6.0) - np.log2(6.0)) < 0.02


def test_host_chain_recovers_true_chain():
    rng = np.random.default_rng(0)
    ax, ay = synthetic_anchors(rng)
    u, bx, by, px, py = lchain_dp_np(
        ax, ay, 2500, 2500, 500, 5, 200, 2, 15, 0.104, 0.0
    )
    assert u.shape[0] >= 1
    best = np.argmax(u[:, 0])
    # the best chain should contain most of the 80 true anchors
    assert u[best, 1] > 50
    # chain anchors increase in both target and query
    s = int(np.sum(u[:best, 1]))
    cx = bx[s : s + int(u[best, 1])]
    cy = by[s : s + int(u[best, 1])]
    assert ((np.diff(cx.astype(np.int64))) >= 0).all()
    assert ((np.diff(cy.astype(np.int64) & 0xFFFFFFFF)) > 0).all()


def _to_planes(ax, ay):
    key = (ax >> np.uint64(32)).astype(np.uint32)
    tpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    qpos = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return key, tpos, qpos


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_device_fill_matches_host_no_skip(seed):
    """Device kernel == host fill when max_skip pruning is disabled (the
    kernel's documented semantics)."""
    import jax.numpy as jnp

    from rawhash_tpu.chain.device import chain_fill_batch

    rng = np.random.default_rng(seed)
    ax, ay = synthetic_anchors(rng, n_true=60, n_noise=40)
    f_h, p_h = lchain_dp_fill_np(ax, ay, 2500, 2500, 500, 10**9, 200, 0.104, 0.0)

    key, tpos, qpos = _to_planes(ax, ay)
    n = ax.shape[0]
    n_cap = 128
    pad = lambda a, c=0: np.concatenate([a, np.full(n_cap - n, c, a.dtype)])
    f_d, p_d = chain_fill_batch(
        jnp.asarray(pad(key)[None, :]),
        jnp.asarray(pad(tpos)[None, :]),
        jnp.asarray(pad(qpos)[None, :]),
        jnp.asarray([n], dtype=np.int32),
        q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500,
        max_iter=200, chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    f_d = np.asarray(f_d)[0, :n]
    p_d = np.asarray(p_d)[0, :n]
    np.testing.assert_array_equal(f_d, f_h)
    np.testing.assert_array_equal(p_d, p_h)


def test_device_fill_geq_host_with_skip():
    """With default max_skip the reference may prune; the kernel never loses
    score."""
    import jax.numpy as jnp

    from rawhash_tpu.chain.device import chain_fill_batch

    rng = np.random.default_rng(7)
    ax, ay = synthetic_anchors(rng, n_true=120, n_noise=100)
    f_h, _ = lchain_dp_fill_np(ax, ay, 2500, 2500, 500, 5, 200, 0.104, 0.0)
    key, tpos, qpos = _to_planes(ax, ay)
    n = ax.shape[0]
    f_d, _ = chain_fill_batch(
        jnp.asarray(key[None, :]),
        jnp.asarray(tpos[None, :]),
        jnp.asarray(qpos[None, :]),
        jnp.asarray([n], dtype=np.int32),
        q_span=SPAN, max_dist_t=2500, max_dist_q=2500, bw=500,
        max_iter=200, chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    assert (np.asarray(f_d)[0, :n] >= f_h).all()


def test_backtrack_and_compact_shapes():
    rng = np.random.default_rng(4)
    ax, ay = synthetic_anchors(rng)
    f, p = lchain_dp_fill_np(ax, ay, 2500, 2500, 500, 5, 200, 0.104, 0.0)
    u, v = chain_backtrack(f, p, min_cnt=2, min_sc=15, max_drop=500)
    assert (u[:, 1] >= 2).all()
    assert (u[:, 0] >= 15).all()
    assert v.shape[0] == u[:, 1].sum()
    us, bx, by, px, py = compact_chains(u, v, ax, ay)
    assert bx.shape[0] == v.shape[0] == px.shape[0]
    # chains sorted by first-anchor target position
    starts = np.concatenate([[0], np.cumsum(us[:, 1])[:-1]])
    firsts = bx[starts]
    assert (np.diff(firsts.astype(np.int64)) >= 0).all()


def test_regions_pipeline():
    rng = np.random.default_rng(5)
    ax, ay = synthetic_anchors(rng)
    u, bx, by, _, _ = lchain_dp_np(ax, ay, 2500, 2500, 500, 5, 200, 2, 15, 0.104, 0.0)
    regs = gen_regs(12345, u.shape[0], u, bx, by)
    assert regs, "no regions"
    # descending score order
    scores = [r.score for r in regs]
    assert scores == sorted(scores, reverse=True)
    set_parent(regs, 0.5, 2**31 - 1, False, 0.15)
    assert regs[0].parent == 0
    regs = select_sub(regs, 0.3, 5, True, 2000)
    set_mapq(regs, 15, rep_len=0, is_dtw=False)
    top = regs[0]
    assert 0 <= top.mapq <= 60
    assert top.rid == 0 and top.rev == 0
    # coordinates cover the true span (t0=5000 .. ~6500)
    assert 4900 < top.rs < 5200
    assert top.mapq > 10  # clean unique mapping should be confident


def _mg_log2_f32(x, contract_inner, contract_outer):
    """mg_log2 in float32, with either multiply-add of its polynomial fused
    into one rounding (a GPU compiler's FMA contraction) or not."""
    f32, f64 = np.float32, np.float64
    a, b, c = f32(-0.34484843), f32(2.02466578), f32(0.67487759)

    def fma(u, v, w):  # one rounding: the exact f64 product, then f32
        return (f64(u) * v.astype(f64) + f64(w)).astype(f32)

    z = x.astype(f32).view(np.uint32)
    log_2 = (((z >> 23) & 255).astype(np.int32) - 128).astype(f32)
    zf = ((z & np.uint32(~(255 << 23) & 0xFFFFFFFF)) + np.uint32(127 << 23)).view(f32)
    t = fma(a, zf, b) if contract_inner else (a * zf + b).astype(f32)
    t = (
        (t.astype(f64) * zf - f64(c)).astype(f32)
        if contract_outer else (t * zf - c).astype(f32)
    )
    return log_2 + t


@pytest.mark.parametrize("preset", sorted(__import__(
    "rawhash_tpu.config", fromlist=["PRESET_NAMES"]).PRESET_NAMES))
def test_gap_penalty_immune_to_fma_in_mg_log2(preset):
    """A GPU compiler may fuse mg_log2's multiply-adds (lchain.c:23-31).
    Over every (dd, dg) the chain fill can score under a preset, the integer
    gap penalty int(gap*dd + skip*dg + 0.5*mg_log2(dd+1)) is the same with
    and without that contraction, so the GPU fill matches the reference."""
    from rawhash_tpu.config import IndexOptions, MapOptions, set_preset

    io, mo = IndexOptions(), MapOptions()
    set_preset(preset, io, mo)
    f32 = np.float32
    span = io.k + io.e - 1
    gap = f32(f32(mo.chain_gap_scale) * f32(0.01) * f32(span))
    skip = f32(f32(mo.chain_skip_scale) * f32(0.01) * f32(span))
    dd = np.arange(1, mo.bw + 1, dtype=np.int64)
    ref = f32(0.5) * _mg_log2_f32(dd + 1, False, False)
    dg = np.arange(0, max(mo.max_target_gap_length, mo.max_query_gap_length,
                          mo.bw) + 1).astype(f32)
    for inner, outer in ((True, False), (False, True), (True, True)):
        fused = f32(0.5) * _mg_log2_f32(dd + 1, inner, outer)
        for row in np.flatnonzero(fused != ref):
            lin = (gap * f32(dd[row]) + skip * dg).astype(f32)
            assert np.array_equal(
                (lin + ref[row]).astype(f32).astype(np.int32),
                (lin + fused[row]).astype(f32).astype(np.int32),
            ), (preset, int(dd[row]), inner, outer)
