"""The GPU chain-fill kernel (Pallas, Triton route) must be bit-identical to
the lax.scan oracle, and each platform must get its fill.

The kernel runs in interpret mode here (the tests force the CPU backend);
chip_smoke.py checks the compiled kernel on the GPU at real widths
(reference recurrence: mg_lchain_dp, lchain.c:385).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rawhash_tpu.chain.device import chain_fill_batch
from rawhash_tpu.chain.pallas_fill import chain_fill_pallas
from rawhash_tpu.map.device_step import select_fill


def _anchors(rng, b, n, n_anchors):
    """Sorted anchors on both strands: diagonal runs plus noise."""
    key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
    tpos = np.sort(rng.integers(0, 5000, (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 7 + rng.integers(-30, 30, (b, n))).clip(0).astype(np.int32)
    noise = rng.random((b, n)) < 0.3
    qpos[noise] = rng.integers(0, 700, int(noise.sum()))
    return [jnp.asarray(x) for x in (key, tpos, qpos, np.asarray(n_anchors, np.int32))]


@pytest.mark.parametrize(
    "b,n,n_anchors,max_iter,bw,skip",
    [
        (3, 300, [300, 211, 17], 200, 500, 0.0),  # W not a power of two
        (5, 257, [0, 257, 1, 2, 100], 200, 500, 0.0),  # empty and tiny reads
        (4, 513, [512, 300, 513, 7], 64, 500, 0.0),  # W a power of two
        (2, 400, [400, 399], 200, 5000, 0.0),  # ava-wide band
        (3, 300, [250, 300, 64], 200, 100, 0.033),  # viral skip penalty
        (1, 130, [130], 3, 500, 0.0),  # window narrower than a warp
    ],
)
def test_fill_kernel_matches_scan(b, n, n_anchors, max_iter, bw, skip):
    args = _anchors(np.random.default_rng(n + b), b, n, n_anchors)
    kw = dict(
        q_span=13, max_dist_t=2500, max_dist_q=2500, bw=bw, max_iter=max_iter,
        chn_pen_gap=0.1352, chn_pen_skip=skip,
    )
    f0, p0 = chain_fill_batch(*args, **kw)
    f1, p1 = chain_fill_pallas(*args, **kw, interpret=True)
    np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))
    np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
    assert (np.asarray(p0) >= 0).any()  # chains formed: not a vacuous check


@pytest.mark.parametrize(
    "platform,fill", [("gpu", chain_fill_pallas), ("cpu", chain_fill_batch)]
)
def test_select_fill(platform, fill):
    assert select_fill(platform) is fill


@pytest.mark.parametrize("platform", ["tpu", "rocm"])
def test_select_fill_unknown_platform(platform):
    with pytest.raises(ValueError, match="no chain fill"):
        select_fill(platform)
