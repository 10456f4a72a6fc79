"""Every `--device` executor name maps onto the batched pipeline's
executors; `host` is the per-read python oracle."""

import numpy as np
import pytest

from circminer_jax import cli
from circminer_jax.config import Config
from circminer_jax.sim import make_genome
from circminer_jax.io.fasta import GenomePacker
from circminer_jax.index.build import build_genome_index
from circminer_jax.annotation.annotation import AnnotationDB


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exec")
    g = make_genome(np.random.default_rng(4), length=30_000, n_genes=2)
    ref, gtf = str(tmp / "ref.fa"), str(tmp / "ref.gtf")
    g.write_fasta(ref)
    g.write_gtf(gtf)
    cfg = Config(kmer=20, max_read_len=100)
    contigs, info = GenomePacker(ref).pack_genome()
    gi = build_genome_index(contigs, cfg)
    db = AnnotationDB.from_gtf(gtf, info, 1, cfg,
                               contig_lengths=[len(c) for c in contigs])
    return db, gi, cfg


@pytest.mark.parametrize("name,chain_exec,extend_exec", [
    ("auto", "auto", "native"),
    ("device", "device", "native"),
    ("device-chain", "device-chain", "native"),
    ("wave", "auto", "device"),
    ("device-full", "device-full", "native"),
    ("native", "native", "native"),
])
def test_executor_name_to_pipeline(tiny, name, chain_exec, extend_exec):
    args = cli.build_parser().parse_args(["-r", "x.fa", "--device", name])
    pipe = cli.make_pipeline(*tiny, args.device)
    assert (pipe.chain_exec, pipe.extend_exec) == (chain_exec, extend_exec)
    assert (pipe.align_svc is not None) == (extend_exec == "device")
    assert len(pipe.filters) == 1 and pipe.filters[0] is not None
    # the host CPU backend reports no memory limit: the wide seg tables
    assert pipe.seg_compact is False


def test_device_choices_are_the_executors_and_the_oracle():
    choices = next(a.choices for a in cli.build_parser()._actions
                   if a.dest == "device")
    assert list(choices) == [*cli.EXECUTORS, "host"]
