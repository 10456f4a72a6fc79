"""Eval tooling (scripts/ equivalents — SURVEY.md §2 #19)."""
import io
import json

import numpy as np
import pytest

from circminer_jax.eval.circ_compare import (CircEvent, load_truth,
                                             match_events, summarize)
from circminer_jax.eval.annotate import build_boundary_maps, annotate_line
from circminer_jax.eval.pam_eval import (cigar_intervals, load_truth_sam,
                                         score_pam_vs_sam, score_pam_vs_sim)
from circminer_jax.eval.report_diff import diff
from circminer_jax.eval.gtf_convert import convert


def test_match_events_tolerance():
    truth = [CircEvent("chr1", 1000, 2000), CircEvent("chr1", 5000, 6000)]
    calls = [CircEvent("chr1", 1005, 1995, 3),   # TP (within 10)
             CircEvent("chr1", 1020, 2000, 1),   # FP (spos off by 20)
             CircEvent("chr2", 5000, 6000, 2)]   # FP (wrong chrom)
    pairs, missed = match_events(calls, truth, bp_res=10)
    s = summarize(pairs, missed)
    assert (s["tp"], s["fp"], s["fn"]) == (1, 2, 1)
    assert s["precision"] == pytest.approx(1 / 3, abs=1e-3)
    assert s["recall"] == 0.5
    assert s["f1"] == pytest.approx(0.4, abs=1e-3)


def test_match_events_one_to_one():
    """Each truth event is claimed at most once (find_TP.py gt_mark)."""
    truth = [CircEvent("chr1", 1000, 2000)]
    calls = [CircEvent("chr1", 1000, 2000, 5),
             CircEvent("chr1", 1001, 2001, 4)]
    pairs, missed = match_events(calls, truth)
    assert pairs[0][1] is not None and pairs[1][1] is None
    assert not missed


def test_load_truth_json(tmp_path):
    p = tmp_path / "truth.json"
    p.write_text(json.dumps({"circ_bp": [[100, 200], [300, 400]]}))
    ev = load_truth(str(p))
    assert [(e.chrom, e.spos, e.epos) for e in ev] == \
        [("chr1", 100, 200), ("chr1", 300, 400)]


def test_annotate(tmp_path):
    gtf = tmp_path / "a.gtf"
    gtf.write_text(
        'chr1\tx\texon\t100\t200\t.\t+\t.\tgene_id "G"; '
        'transcript_id "T1"; exon_number "1";\n'
        'chr1\tx\texon\t300\t400\t.\t+\t.\tgene_id "G"; '
        'transcript_id "T1"; exon_number "2";\n')
    beg, end = build_boundary_maps(str(gtf))
    out = annotate_line("chr1\t100\t400\t5\tSTC", beg, end)
    assert out.endswith("T1(G)[1-2]")
    out2 = annotate_line("chr1\t101\t400\t5\tSTC", beg, end)
    assert out2.endswith("NA")
    hdr = annotate_line("chr\tspos\tepos", beg, end)
    assert hdr.endswith("transcripts")


def test_cigar_intervals():
    # 50M 100N 50M at pos 1000 -> two reference intervals split on intron
    assert cigar_intervals(1000, "50M100N50M") == \
        [(1000, 1049), (1150, 1199)]
    # soft clips and insertions consume no reference
    assert cigar_intervals(10, "5S20M3I15M2D10M5S") == [(10, 56)]


def test_score_pam_vs_sam(tmp_path):
    sam = tmp_path / "t.sam"
    sam.write_text(
        "@HD\tVN:1.4\n"
        "r0\t0\tchr1\t1000\t60\t100M\t*\t0\t0\tA\tI\n"
        "r0\t16\tchr1\t1200\t60\t100M\t*\t0\t0\tA\tI\n"
        "r1\t0\tchr1\t5000\t60\t100M\t*\t0\t0\tA\tI\n"
        "r1\t16\tchr1\t5200\t60\t100M\t*\t0\t0\tA\tI\n")
    pam = tmp_path / "m.pam"
    pam.write_text(
        "r0\tchr1\t1000\t1099\t100\t1\t100\t+\t0\t"
        "chr1\t1200\t1299\t100\t1\t100\t-\t0\t300\t0\t1\t0\n"
        "r1\tchr1\t9000\t9099\t100\t1\t100\t+\t0\t"
        "chr1\t9200\t9299\t100\t1\t100\t-\t0\t300\t0\t1\t0\n"
        "r2\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t*\t14\n")
    res = score_pam_vs_sam(str(pam), load_truth_sam(str(sam)))
    assert res["reads"] == 3 and res["mapped"] == 2 and res["correct"] == 1


def test_score_pam_vs_sim(tmp_path):
    pam = tmp_path / "m.pam"
    pam.write_text(
        "L0\tchr1\t1\t100\t100\t1\t100\t+\t0\tchr1\t200\t299\t100\t1\t100"
        "\t-\t0\t300\t0\t1\t0\n"
        "C0\t" + "\t".join(["*"] * 20) + "\t7\n"   # CHIBSJ=7? use config
    )
    from circminer_jax.config import CHIBSJ
    # rewrite with the real category value
    pam.write_text(
        "L0\tchr1\t1\t100\t100\t1\t100\t+\t0\tchr1\t200\t299\t100\t1\t100"
        "\t-\t0\t300\t0\t1\t0\n"
        "C0\t" + "\t".join(["*"] * 20) + f"\t{CHIBSJ}\n")
    res = score_pam_vs_sim(str(pam))
    assert res["linear"]["frac"] == 1.0
    assert res["circ"]["frac"] == 1.0


def test_report_diff(tmp_path):
    a = tmp_path / "a.report"
    b = tmp_path / "b.report"
    a.write_text("chr1\t100\t200\t2\tSTC\tAA-BB\tAA-BB\tPass\tr1,r2\n"
                 "chr1\t300\t400\t1\tSTC\tAA-BB\tAA-BB\tPass\tr9\n")
    b.write_text("chr1\t100\t200\t3\tSTC\tAA-BB\tAA-BB\tPass\tr1,r3,r4\n")
    buf = io.StringIO()
    res = diff(str(a), str(b), out=buf)
    assert res == {"common": 1, "only_a": 1, "only_b": 0}
    line = buf.getvalue().splitlines()[0].split("\t")
    assert line[5] == "r2" and line[6] == "r3,r4"


def test_gtf_convert(tmp_path):
    src = tmp_path / "ucsc.gtf"
    src.write_text(
        'chr1\tsrc\texon\t100\t200\t.\t+\t.\tgene_id "G1"; '
        'transcript_id "T1";\n'
        'chr1\tsrc\texon\t300\t500\t.\t+\t.\tgene_id "G1"; '
        'transcript_id "T1";\n')
    dst = tmp_path / "ens.gtf"
    convert(str(src), str(dst))
    lines = dst.read_text().splitlines()
    feats = [l.split("\t")[2] for l in lines]
    assert feats == ["gene", "transcript", "exon", "exon"]
    g = lines[0].split("\t")
    assert (g[3], g[4]) == ("100", "500")
    # converted GTF round-trips through our parser
    from circminer_jax.io.gtf import parse_gtf_records
    recs = list(parse_gtf_records(str(dst)))
    assert all(r.gid == "G1" for r in recs)


def test_eval_cli_on_pipeline_output(tmp_path):
    """End-to-end: run the CLI, then score its report with circ_compare."""
    from circminer_jax.sim import make_genome, simulate_reads, write_fastq
    from circminer_jax.cli import main as cli_main
    from circminer_jax.eval.circ_compare import main as cmp_main
    rng = np.random.default_rng(3)
    g = make_genome(rng, length=30_000, n_genes=2)
    ref, gtf = str(tmp_path / "ref.fa"), str(tmp_path / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    reads, truth = simulate_reads(rng, g, 40, 40)
    write_fastq(reads, str(tmp_path / "R1.fq"), str(tmp_path / "R2.fq"))
    (tmp_path / "truth.json").write_text(json.dumps({"circ_bp": truth}))
    assert cli_main(["--index", "-r", ref, "-k", "20"]) == 0
    out = str(tmp_path / "out")
    assert cli_main(["-r", ref, "-g", gtf, "-1", str(tmp_path / "R1.fq"),
                     "-2", str(tmp_path / "R2.fq"), "-o", out]) == 0
    assert cmp_main([str(tmp_path / "truth.json"), out + ".circ_report",
                     "--json"]) == 0
    # direct: all truth events recovered
    truth_ev = load_truth(str(tmp_path / "truth.json"))
    calls = load_truth(out + ".circ_report")
    pairs, missed = match_events(calls, truth_ev)
    s = summarize(pairs, missed)
    assert s["recall"] >= 0.99 and s["precision"] >= 0.99, s
