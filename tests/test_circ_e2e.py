"""End-to-end circRNA detection through the CLI surface."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from circminer_jax.cli import main as cli_main
from circminer_jax.sim import make_genome, simulate_reads, write_fastq


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clie2e")
    rng = np.random.default_rng(42)
    g = make_genome(rng, length=50_000, n_genes=3)
    g.write_fasta(str(tmp / "ref.fa"))
    g.write_gtf(str(tmp / "ref.gtf"))
    reads, truth = simulate_reads(rng, g, 140, 60)
    write_fastq(reads, str(tmp / "R1.fq"), str(tmp / "R2.fq"))
    return tmp, truth


def test_cli_end_to_end(dataset, monkeypatch):
    tmp, truth = dataset
    monkeypatch.chdir(tmp)
    assert cli_main(["--index", "-r", "ref.fa", "-k", "20"]) == 0
    assert cli_main(["-r", "ref.fa", "-g", "ref.gtf", "-1", "R1.fq",
                     "-2", "R2.fq", "-o", "out", "--pam"]) == 0

    # mapping output exists and has one line per pair
    pam = (tmp / "out.mapping.pam").read_text().strip().split("\n")
    assert len(pam) == 200

    report = (tmp / "out.circ_report").read_text().strip()
    assert report, "no circRNAs reported"
    found = set()
    for line in report.split("\n"):
        f = line.split("\t")
        assert f[0] == "chr1"
        assert f[4] == "STC"
        assert f[7] == "Pass"
        # support count matches listed read names
        assert int(f[3]) == len(f[8].split(","))
        found.add((int(f[1]), int(f[2])))
    # every true circRNA with >=1 junction-covering read is reported exactly
    assert found == {tuple(bp) for bp in truth}


def test_remain_fastq_roundtrip(dataset):
    """The 23-token remain-FASTQ header channel parses back identically."""
    tmp, _ = dataset
    from circminer_jax.config import Config
    from circminer_jax.io.fastq import FastqReader, format_map_comment
    cfg = Config()
    p = tmp / "out_1_remain_R1.fastq"
    assert p.exists()
    n = 0
    for rec in FastqReader(str(p), cfg):
        assert rec.mr.type in (3, 4)  # CHIBSJ / CHI2BSJ only reach stage 2
        # re-format and re-parse: fixpoint
        c1 = format_map_comment(rec.mr)
        toks = (rec.rname + c1).split(" ")
        from circminer_jax.pipeline.types import MatchedRead
        mr2 = MatchedRead.default(cfg.max_ed)
        from circminer_jax.io.fastq import parse_map_comment
        parse_map_comment(toks, mr2, cfg.max_ed)
        assert mr2.spos_r1 == rec.mr.spos_r1
        assert mr2.type == rec.mr.type
        assert mr2.genome_spos == rec.mr.genome_spos
        n += 1
    assert n > 0
