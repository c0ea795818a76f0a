"""Tests for the benchmark CLI (C16, ``main.cu:146-160``).

The reference demo has no automated test; these exercise the argparse
layer, the 3-kernel sweep, the PageRank demo, and the ``--matrix``
Matrix-Market entry point end-to-end on the fake (CPU) backend.
"""

import json

import numpy as np

from jax_spmv.cli import main
from jax_spmv.csr import csr_from_dense
from jax_spmv.io import save_matrix_market


def test_cli_generated_sweep(capsys):
    rc = main(["--rows", "64", "--cols", "48", "--density", "0.1",
               "--runs", "2", "--pagerank-nodes", "30"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SCALAR_CSR" in out and "VECTOR_CSR" in out
    assert "MERGE_PATH" in out
    assert "correct=True" in out and "correct=False" not in out
    assert "PageRank: 30 nodes" in out
    assert "top-10 nodes" in out


def test_cli_matrix_market_input(tmp_path, capsys):
    rng = np.random.default_rng(7)
    dense = (rng.random((50, 40)) < 0.15).astype(np.float32)
    dense *= rng.standard_normal((50, 40)).astype(np.float32)
    csr = csr_from_dense(dense)
    path = str(tmp_path / "input.mtx")
    save_matrix_market(csr, path)

    rc = main(["--matrix", path, "--runs", "2", "--skip-pagerank"])
    assert rc == 0
    out = capsys.readouterr().out
    # dims come from the file, not the --rows/--cols defaults
    assert f"50x40 ({path})" in out
    assert f"nnz {csr.nnz}" in out
    assert "correct=True" in out and "correct=False" not in out


def test_cli_json_emission(capsys):
    rc = main(["--rows", "32", "--cols", "32", "--density", "0.2",
               "--runs", "2", "--json", "--pagerank-nodes", "20"])
    assert rc == 0
    out = capsys.readouterr().out
    # every JSON blob in the output must parse
    blobs = [chunk for chunk in out.split("\n{") if '"' in chunk]
    assert blobs, "expected JSON output with --json"
    pr = json.loads("{" + out.rsplit("\n{", 1)[1])
    assert pr["iterations"] >= 1
    assert len(pr["top_k"]) == 10
