"""The port's CLI against the JAX package's: the same subcommands on the
same inputs print the same text (the port with --device cpu, the JAX CLI
with its host backend; its stream subcommand has no backend)."""

import json

import pytest

from kmer_spans_tpu import cli as ref_cli
from kmer_spans_tpu.io.fasta import write_fasta
from kmer_spans_tpu.utils.testgen import spectrum_checksum
from kmer_spans_tpu_torch import cli
from kmer_spans_tpu_torch.encoding import all_kmers
from kmer_spans_tpu_torch.io.spectrum_file import read_kmers


@pytest.fixture()
def fasta(tmp_path, golden):
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr1", golden)])
    return str(p)


@pytest.fixture()
def two_scaffolds(tmp_path, golden):
    p = tmp_path / "multi.fa"
    write_fasta(p, [("s1", golden[:40_000]), ("s2", golden[40_000:])])
    return str(p)


def _both(argv, capsys, backend=True):
    """(port out, port err, JAX out, JAX err) of one command line."""
    cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    ref_cli.main(argv + (["--backend", "host"] if backend else []))
    want = capsys.readouterr()
    return got.out, got.err, want.out, want.err


def test_spans(fasta, capsys):
    out, err, want, want_err = _both(
        ["spans", fasta, "-k", "8", "--min-width", "100",
         "--min-score", "20"], capsys)
    assert out == want and err == want_err
    lines = out.splitlines()
    assert len(lines) == 4
    assert lines[1].startswith("chr1\t20008\t20600\t137.923657")


def test_spans_threshold_scoring(fasta, capsys):
    out, err, want, want_err = _both(
        ["spans", fasta, "-k", "8", "--scoring", "threshold", "--f-t",
         "0.0001", "--min-width", "100", "--min-score", "50"], capsys)
    assert out == want and err == want_err
    assert out.splitlines()[1].startswith("chr1\t20008\t20600")


def test_count_json(fasta, capsys):
    out, _, want, _ = _both(["count", fasta, "-k", "2"], capsys)
    assert out == want
    data = json.loads(out)
    assert data["k"] == 2 and data["n"] > 0 and len(data["top"]) == 10


def test_count_spectrum_file(fasta, tmp_path, capsys):
    got_bin, want_bin = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    cli.main(["count", fasta, "-k", "8", "--out", got_bin, "--device",
              "cpu"])
    out = capsys.readouterr().out
    ref_cli.main(["count", fasta, "-k", "8", "--out", want_bin,
                  "--backend", "host"])
    assert out.replace(got_bin, want_bin) == capsys.readouterr().out
    back = read_kmers(got_bin)
    assert back["k"] == [8]
    assert spectrum_checksum(back["counts"][0]) == 6585132732039205817
    with open(got_bin, "rb") as a, open(want_bin, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("counts", [True, False])
def test_windows(fasta, capsys, counts):
    out, _, want, _ = _both(
        ["windows", fasta, "--kmers", "CG,AT", "--window", "200"]
        + (["--counts"] if counts else []), capsys, backend=False)
    assert out == want
    assert out.splitlines()[0] == "count\tCG\tAT"


def test_kmers(capsys):
    cli.main(["kmers", "-k", "3"])
    out = capsys.readouterr().out
    ref_cli.main(["kmers", "-k", "3"])
    assert out == capsys.readouterr().out
    assert out.splitlines()[:4] == ["AAA", "AAC", "AAT", "AAG"]


def test_regions(fasta, tmp_path, capsys):
    scores = tmp_path / "scores.tsv"
    with open(scores, "w") as fh:
        for km in all_kmers(2):
            fh.write(f"{km}\t{3.0 if km == 'AG' else -1.0}\n")
    out, _, want, _ = _both(
        ["regions", fasta, "-k", "2", "--scores", str(scores),
         "--min-width", "50", "--min-score", "20"], capsys)
    assert out == want
    assert len(out.splitlines()) > 1


def test_lr(tmp_path, capsys):
    fa = tmp_path / "cpg.fa"
    write_fasta(fa, [("s", "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG")])
    scores = tmp_path / "lr.tsv"
    with open(scores, "w") as fh:
        for km in sorted(all_kmers(2)):
            seed = 2.0 if km == "CG" else -1.0
            trans = 2.0 if km == "CG" else -0.5
            fh.write(f"{km}\t{seed}\t{trans}\n")
    out, _, want, _ = _both(
        ["lr", str(fa), "-k", "2", "--scores", str(scores),
         "--min-length", "4"], capsys)
    assert out == want
    assert out.splitlines()[1].startswith("s\t10\t20\t9.5")


def test_stream_with_checkpoint_and_metrics(fasta, capsys, tmp_path):
    argv = ["stream", fasta, "-k", "8", "--chunk", "32768", "--block", "512",
            "--cand-blocks", "32", "--min-width", "100", "--min-score", "20",
            "--metrics"]
    cli.main(argv + ["--checkpoint", str(tmp_path / "port.npz"),
                     "--device", "cpu"])
    got = capsys.readouterr()
    ref_cli.main(argv + ["--checkpoint", str(tmp_path / "jax.npz")])
    want = capsys.readouterr()
    assert got.out == want.out
    lines = got.out.splitlines()
    assert len(lines) == 4
    assert lines[1].startswith("chr1\t20008\t20600\t137.92")
    assert got.err.splitlines()[0] == want.err.splitlines()[0]
    assert "0 unresolved" in got.err
    phases = json.loads(got.err.splitlines()[1])["phases"]
    assert [p["name"] for p in phases[:3]] == ["count", "rank", "scan_chunk"]
    assert (tmp_path / "port.npz.0.npz").exists()


def test_stream_two_scaffolds(two_scaffolds, capsys):
    argv = ["stream", two_scaffolds, "-k", "8", "--chunk", "16384",
            "--block", "512", "--cand-blocks", "32", "--min-width", "100",
            "--min-score", "20"]
    out, err, want, want_err = _both(argv, capsys, backend=False)
    assert out == want and err == want_err
    lines = out.splitlines()
    assert len(lines) == 4
    assert lines[1].startswith("s1\t20008\t20600")
    assert lines[2].startswith("s2\t10008\t10900")
    assert lines[3].startswith("s2\t40007\t40400")


def test_wide_is_not_ported_yet(fasta, capsys):
    """The wide subcommand (the name dates from before its port): stdout
    and stderr equal to the JAX CLI's."""
    out, err, want, want_err = _both(
        ["wide", fasta, "-k", "17", "--min-width", "100", "--min-score",
         "20"], capsys)
    assert out == want and err == want_err
    lines = out.splitlines()
    assert len(lines) == 4
    assert lines[1].startswith("chr1\t20017\t20600\t136.02952")
    assert err.startswith("# 3 regions, 99984 k-mers, ")


def test_device_defaults_to_cuda(fasta):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["spans", fasta, "-k", "8"])


def _both_backend(argv, capsys, backend):
    """(port out, port err, JAX out, JAX err) with --backend on both: the
    port's default --device cuda is not used under a CPU backend."""
    cli.main(argv + ["--backend", backend])
    got = capsys.readouterr()
    ref_cli.main(argv + ["--backend", backend])
    want = capsys.readouterr()
    return got.out, got.err, want.out, want.err


@pytest.mark.parametrize("backend", ["host", "native"])
@pytest.mark.parametrize("cmd", ["spans", "threshold", "count", "wide"])
def test_cpu_backends_print_what_the_jax_cli_prints(fasta, capsys, backend,
                                                    cmd):
    argv = {
        "spans": ["spans", fasta, "-k", "8"],
        "threshold": ["spans", fasta, "-k", "8", "--scoring", "threshold",
                      "--f-t", "0.0001", "--min-score", "50"],
        "count": ["count", fasta, "-k", "6", "--top", "5"],
        "wide": ["wide", fasta, "-k", "17"],
    }[cmd]
    out, err, want, want_err = _both_backend(argv, capsys, backend)
    assert out == want and err == want_err
    if cmd != "count":
        assert len(out.splitlines()) == 4
    if cmd == "wide":
        assert err.startswith("# 3 regions, 99984 k-mers, 98137 distinct")


@pytest.mark.parametrize("backend", ["host", "native"])
def test_cpu_backends_regions_and_lr(tmp_path, two_scaffolds, capsys,
                                     backend):
    scores = tmp_path / "scores.tsv"
    with open(scores, "w") as fh:
        for km in all_kmers(2):
            fh.write(f"{km}\t{3.0 if km == 'AG' else -1.0}\n")
    out, _, want, _ = _both_backend(
        ["regions", two_scaffolds, "-k", "2", "--scores", str(scores),
         "--min-width", "50", "--min-score", "20"], capsys, backend)
    assert out == want and len(out.splitlines()) > 1
    lr = tmp_path / "lr.tsv"
    with open(lr, "w") as fh:
        for km in sorted(all_kmers(2)):
            fh.write(f"{km}\t{1.0 if km in ('AG', 'GA') else -1.0}\t"
                     f"{0.8 if km in ('AG', 'GA') else -0.5}\n")
    out, _, want, _ = _both_backend(
        ["lr", two_scaffolds, "-k", "2", "--scores", str(lr),
         "--min-length", "100"], capsys, backend)
    assert out == want and out.splitlines()[1].startswith("s1\t")


@pytest.mark.parametrize("backend", ["jax", "gpu"])
def test_backend_choices(fasta, backend, capsys):
    """The port has no "jax" backend: argparse refuses it, as any name
    outside auto, host and native."""
    with pytest.raises(SystemExit):
        cli.main(["spans", fasta, "--backend", backend])
    assert "invalid choice" in capsys.readouterr().err
