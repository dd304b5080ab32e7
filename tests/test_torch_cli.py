"""The port's command line (insider_tpu_torch/cli.py, python -m
insider_tpu_torch) against the JAX package's (insider_tpu/cli.py) and
against the port's own in-process Insider.

Exact: _parse_seq, _looks_like_header and _load_table (csv, tsv, npy, npz,
--skip-cols, --log2) return what the JAX CLI's return, bit for bit (the
same native parser, the JAX binding's built privately by
tests/jax_native_private.py; the same f64 widening before log2);
`simulate` writes the JAX CLI's npz.  Bit for bit: `fit` and `tune` at
--device cpu equal the port's in-process Insider built from the same table
(the same split, initial factors and plain versions).  The saved npz and
JSON have the JAX CLI's keys.  Without a card, the default --device cuda
raises.  Tables are made from seeded numpy generators at 12 x 30.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import insider_tpu.cli as jcli
import insider_tpu_torch as itt
from insider_tpu_torch import cli
from jax_native_private import jax_native  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent


def _sim_table(tmp_path, name="t.csv", delim=",", header=True, skip=0):
    """The 12 x 30 table of simulate_insider_data(6, 2, 30, 2) as a file:
    `skip` id columns, 2 confounder columns, then the expression values
    (non-negative, 5% NA), written with %.9g."""
    sim = itt.simulate_insider_data(v1_num=6, v2_num=2, gene_num=30,
                                    latent_dim=2, seed=4)
    rng = np.random.default_rng(4)
    data = np.abs(sim.data).astype(np.float32)
    data[rng.random(data.shape) < 0.05] = np.nan
    ids = np.arange(1, 13)[:, None] * np.ones((1, skip))
    table = np.column_stack([ids, sim.confounder[:, :2], data])
    path = tmp_path / name
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(f'"c{i}"' for i in range(table.shape[1]))
                     + "\n")
        for row in table:
            fh.write(delim.join("NA" if np.isnan(v) else "%.9g" % v
                                for v in row) + "\n")
    return str(path), table


@pytest.mark.parametrize("spec,integer", [
    ("1,2,3", True), ("10:31:2", True), ("0.1:1:0.2", False),
    ("0.5,1,2.5", False), ("5:8", True), ("0.0", False)])
def test_parse_seq_matches_jax(spec, integer):
    got = cli._parse_seq(spec, integer=integer)
    want = jcli._parse_seq(spec, integer=integer)
    assert got == want
    assert [type(v) for v in got] == [type(v) for v in want]


@pytest.mark.parametrize("line,delim,header", [
    ("a,b,c\n", ",", True), ("1e5,2,3\n", ",", False),
    ("NA,1,2\n", ",", False), ('"gene",1\n', ",", True),
    ("1.5\t2\tNaN\r\n", "\t", False), (",,\n", ",", False),
    ("id\t3\n", "\t", True), ('"1",N/A,-2.5e-3\n', ",", False),
    ("1,2,inf\n", ",", False), ("1,N5\n", ",", True)])
def test_looks_like_header_matches_jax(line, delim, header):
    """1e5 and NA are data, not a header (the JAX CLI's semantics)."""
    assert cli._looks_like_header(line, delim) is header
    assert jcli._looks_like_header(line, delim) is header


def _same_table(got, want):
    (gd, gc), (wd, wc) = got, want
    assert gd.dtype == wd.dtype == np.float64
    np.testing.assert_array_equal(gd.view(np.uint64), wd.view(np.uint64))
    if wc is None:
        assert gc is None
    else:
        assert gc.dtype == wc.dtype
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("fmt", ["csv", "csv-noheader", "tsv", "txt"])
@pytest.mark.parametrize("log2", [False, True])
@pytest.mark.parametrize("skip", [0, 1])
def test_load_table_text_matches_jax(jax_native, tmp_path, fmt, log2,
                                     skip):
    delim = "," if fmt.startswith("csv") else "\t"
    ext = fmt.split("-")[0]
    path, _ = _sim_table(tmp_path, f"t.{ext}", delim,
                         header=fmt != "csv-noheader", skip=skip)
    _same_table(cli._load_table(path, 2, log2, skip),
                jcli._load_table(path, 2, log2, skip))


@pytest.mark.parametrize("log2", [False, True])
def test_load_table_binary_matches_jax(tmp_path, log2):
    """.npy (with --skip-cols), .npz with and without 'confounder'."""
    _, table = _sim_table(tmp_path, skip=1)
    npy = str(tmp_path / "t.npy")
    np.save(npy, table)
    _same_table(cli._load_table(npy, 2, log2, 1),
                jcli._load_table(npy, 2, log2, 1))
    with_conf = str(tmp_path / "c.npz")
    np.savez(with_conf, data=table[:, 3:], confounder=table[:, 1:3])
    _same_table(cli._load_table(with_conf, 2, log2, 0),
                jcli._load_table(with_conf, 2, log2, 0))
    no_conf = str(tmp_path / "n.npz")
    np.savez(no_conf, data=table[:, 1:])
    for cols in (0, 2):
        _same_table(cli._load_table(no_conf, cols, log2, 0),
                    jcli._load_table(no_conf, cols, log2, 0))


@pytest.mark.parametrize("argv", [
    ["--preset", "insider", "--v1", "6", "--v2", "2", "--cols", "30",
     "--rank", "2", "--seed", "3"],
    ["--preset", "scale", "--rows", "40", "--cols", "25", "--rank", "3",
     "--levels", "4,9", "--noise", "0.5"]])
def test_simulate_matches_jax(tmp_path, argv, capsys):
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cli.main(["simulate", *argv, "--out", a])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["simulate", *argv, "--out", b])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == want["shape"]
    assert out["confounders"] == want["confounders"]
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files) == ["confounder", "data",
                                                    "gene_factor"]
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])


FIT_ARGS = ["--confounder-cols", "2", "--interaction", "0,1", "--log2",
            "--rank", "3", "--lam", "1.0", "--alpha", "0.3",
            "--max-iter", "20", "--global-tol", "1e-10"]


def _in_process(path, partition):
    data, conf = cli._load_table(path, 2, True, 0)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], global_tol=1e-10,
                      max_iter=20, device="cpu")
    return obj.fit(3, 1.0, 0.3, partition=partition, verbose=False)


def _check_saved(out, obj):
    z = np.load(out)
    n = len(obj.cfd_matrices)
    assert sorted(z.files) == sorted([f"factor{i}" for i in range(n)]
                                     + ["column_factor"])
    for i, f in enumerate(obj.cfd_matrices):
        np.testing.assert_array_equal(z[f"factor{i}"], f)
    np.testing.assert_array_equal(z["column_factor"], obj.column_factor)
    with open(out + ".json") as fh:
        meta = json.load(fh)
    assert sorted(meta) == ["loss", "n_iter", "test_rmse", "train_rmse"]
    assert meta["loss"] == obj.fit_result.loss
    assert meta["n_iter"] == obj.fit_result.n_iter
    assert meta["train_rmse"] == obj.fit_result.train_rmse
    return meta


@pytest.mark.parametrize("partition", ["0", "1"])
def test_fit_equals_in_process_insider(tmp_path, partition):
    """fit --device cpu: the saved factors and loss equal an in-process
    Insider on the same table bit for bit; the log's boundary records are
    the fit's history."""
    path, _ = _sim_table(tmp_path)
    out, log = str(tmp_path / "fitted.npz"), str(tmp_path / "fit.jsonl")
    cli.main(["fit", "--data", path, *FIT_ARGS, "--partition", partition,
              "--device", "cpu", "--out", out, "--log-jsonl", log])
    obj = _in_process(path, int(partition))
    _check_saved(out, obj)
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["loss"] for r in recs] == [h["loss"]
                                        for h in obj.fit_result.history]


def test_saved_files_have_the_jax_cli_keys(jax_native, tmp_path, capsys):
    """The JAX CLI's fit on the same table saves the same npz keys (and
    shapes) and JSON fields as the port's."""
    path, _ = _sim_table(tmp_path)
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    cli.main(["fit", "--data", path, *FIT_ARGS, "--partition", "1",
              "--device", "cpu", "--out", a])
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["fit", "--data", path, *FIT_ARGS, "--partition", "1",
               "--out", b])
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].shape == zb[k].shape
    with open(a + ".json") as fa, open(b + ".json") as fb:
        assert sorted(json.load(fa)) == sorted(json.load(fb))
    assert sorted(port_line) == sorted(jax_line)


def test_tune_equals_in_process_insider(tmp_path, capsys):
    """tune --device cpu: the printed result and both CSV files equal an
    in-process Insider.tune on the same table bit for bit."""
    path, _ = _sim_table(tmp_path)
    cli_dir, own_dir = tmp_path / "cli", tmp_path / "own"
    cli_dir.mkdir()
    own_dir.mkdir()
    cli.main(["tune", "--data", path, "--confounder-cols", "2",
              "--interaction", "0,1", "--log2", "--ranks", "2,3",
              "--lambdas", "0.5,1", "--alphas", "0.3", "--tuning-iter", "10",
              "--device", "cpu", "--out-dir", str(cli_dir)])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    data, conf = cli._load_table(path, 2, True, 0)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], tuning_iter=10,
                      device="cpu")
    want = obj.tune([2, 3], [0.5, 1.0], [0.3], out_dir=str(own_dir))
    assert got["latent_rank"] == want["latent_rank"]
    assert got["rank_tuning"] == want["rank_tuning"].tolist()
    assert got["reg_tuning"] == want["reg_tuning"].tolist()
    names = sorted(os.listdir(cli_dir))
    assert names == sorted(os.listdir(own_dir)) == sorted([
        "insider_rank_tuning_result.csv",
        f"insider_R{want['latent_rank']}_reg_tuning_result.csv"])
    for n in names:
        assert (cli_dir / n).read_text() == (own_dir / n).read_text()


def test_no_covariates_mode(tmp_path):
    """--confounder-cols 0: every row its own category (README's "no
    covariates" mode), as the JAX CLI builds it."""
    path, _ = _sim_table(tmp_path)
    out = str(tmp_path / "f.npz")
    cli.main(["fit", "--data", path, "--confounder-cols", "0", "--rank", "2",
              "--lam", "1", "--alpha", "0.3", "--max-iter", "5",
              "--device", "cpu", "--out", out])
    assert np.load(out)["factor0"].shape == (12, 2)


def test_default_device_without_a_card_raises(tmp_path):
    """No fallback: fit and tune run on the card unless --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    path, _ = _sim_table(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["fit", "--data", path, *FIT_ARGS, "--out",
                  str(tmp_path / "f.npz")])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["tune", "--data", path, "--confounder-cols", "2",
                  "--ranks", "2,3", "--out-dir", str(tmp_path)])
    assert not (tmp_path / "f.npz").exists()


def test_help_lists_the_commands(capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main(["--help"])
    assert ei.value.code == 0
    text = capsys.readouterr().out
    assert "{fit,tune,simulate}" in text
    with pytest.raises(SystemExit):
        cli.main(["fit", "--help"])
    assert "--device" in capsys.readouterr().out


def test_python_m_fit_subprocess(tmp_path):
    """python -m insider_tpu_torch fit runs in a process of its own (no
    JAX loaded) and saves the in-process fit bit for bit."""
    path, _ = _sim_table(tmp_path)
    out = str(tmp_path / "fitted.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_module('insider_tpu_torch', run_name='__main__'); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'insider_tpu')))")
    proc = subprocess.run(
        [sys.executable, "-c", code, "insider_tpu_torch", "fit", "--data",
         path, *FIT_ARGS, "--partition", "1", "--device", "cpu", "--out",
         out], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    meta = _check_saved(out, _in_process(path, 1))
    assert json.loads(proc.stdout.strip().splitlines()[-2]) == meta
