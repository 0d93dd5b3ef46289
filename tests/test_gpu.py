"""Checks that need the GPU: the compiled chain-fill kernel against the
lax.scan oracle at the engine's widths.  They skip elsewhere; on a machine
with the card run `python -m pytest -m gpu tests/test_gpu.py`."""

import subprocess
import sys

import pytest

pytestmark = pytest.mark.gpu

FILL_CHECK = """
import jax, numpy as np, jax.numpy as jnp
assert jax.devices()[0].platform == "gpu", jax.devices()
from rawhash_tpu.chain.device import chain_fill_batch
from rawhash_tpu.chain.pallas_fill import chain_fill_pallas
rng = np.random.default_rng(3)
b, n = 256, 3072
key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
tpos = np.sort(rng.integers(0, 200000, (b, n)), axis=1).astype(np.int32)
qpos = (tpos // 9 + rng.integers(-40, 40, (b, n))).clip(0).astype(np.int32)
n_anchors = rng.integers(0, n + 1, b).astype(np.int32)
args = [jnp.asarray(x) for x in (key, tpos, qpos, n_anchors)]
kw = dict(q_span=13, max_dist_t=2500, max_dist_q=2500, bw=500,
          max_iter=200, chn_pen_gap=0.104, chn_pen_skip=0.0)
f0, p0 = chain_fill_batch(*args, **kw)
f1, p1 = chain_fill_pallas(*args, **kw)
np.testing.assert_array_equal(np.asarray(f0), np.asarray(f1))
np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
assert (np.asarray(p0) >= 0).sum() > b
print("FILL_OK")
"""


def test_fill_kernel_compiled_matches_scan(gpu_env):
    out = subprocess.run(
        [sys.executable, "-c", FILL_CHECK], env=gpu_env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FILL_OK" in out.stdout
