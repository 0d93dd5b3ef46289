"""CLI end-to-end: index build/dump/load and mapping through the command
surface, using files on disk (the reference's canonical two-step workflow,
test/scripts/run_rawhash2.sh)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from rawhash_tpu.io.signal_gen import simulate_reads
from rawhash_tpu.io.sigfile import write_sig_npz
from rawhash_tpu.pore import synthetic_pore

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# CLI subprocesses run on the CPU backend, like the rest of the tests.
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    (d / "ref.fa").write_text(f">chr1\n{genome}\n")
    pore = synthetic_pore(k=6)
    # standard pore-model file format
    bases = "ACGT"
    with open(d / "pore.model", "w") as fp:
        fp.write("kmer\tlevel_mean\tlevel_stdv\n")
        for i, v in enumerate(pore.pore_vals):
            kmer = "".join(bases[(i >> (2 * (5 - j))) & 3] for j in range(6))
            fp.write(f"{kmer}\t{90 + 12*v:.4f}\t2.0\n")
    reads = simulate_reads(genome, pore, n_reads=3, read_len=500, rng=rng)
    write_sig_npz(str(d / "reads.sig.npz"), [(n, s) for n, s, _, _ in reads])
    return d


def run_cli(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "rawhash_tpu", *args],
        capture_output=True, text=True, cwd=str(cwd), env=ENV, timeout=500,
    )


def test_cli_index_build_and_dump(workdir):
    r = run_cli(
        ["-x", "sensitive", "-p", "pore.model", "-d", "ref.rhi.npz", "ref.fa"],
        workdir,
    )
    assert r.returncode == 0, r.stderr
    assert (workdir / "ref.rhi.npz").exists()
    assert "built index" in r.stderr


def test_cli_mapping_produces_paf(workdir):
    assert (workdir / "ref.rhi.npz").exists()
    r = run_cli(
        ["-x", "sensitive", "--max-anchors", "512", "ref.rhi.npz",
         "reads.sig.npz"],
        workdir,
    )
    assert r.returncode == 0, r.stderr
    lines = [l for l in r.stdout.strip().split("\n") if l]
    assert len(lines) == 3
    for line in lines:
        cols = line.split("\t")
        assert cols[0].startswith("sim_read_")
        assert len(cols) >= 13


def test_cli_out_quantize(workdir):
    r = run_cli(["--out-quantize", "reads.sig.npz"], workdir)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().split("\n")
    assert lines[0] == "sim_read_0"
    codes = lines[1].split(",")
    assert len(codes) > 100
    assert all(0 <= int(c) < 16 for c in codes)


def test_cli_version():
    r = subprocess.run(
        [sys.executable, "-m", "rawhash_tpu", "--version"],
        capture_output=True, text=True, env=ENV, timeout=120,
    )
    assert r.returncode == 0
    assert "rawhash-tpu" in r.stdout
