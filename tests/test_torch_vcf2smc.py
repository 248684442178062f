"""The port's ``vcf2smc`` (smcpp_tpu_torch/data/vcf.py through the port's
CLI) against the JAX package's through the JAX CLI: the same VCF and the
same arguments must give the same SMC++ text after decompression (gzip
stamps a time and a name), and the same errors.

The VCFs are written here from a seed: every one holds '.' genotypes,
multi-allelic, indel and ``ALT=.`` records (skipped), duplicate positions,
records of another contig and FORMAT fields after GT.  Phase 9 of
chip_smoke.py (a VCF from ``simulate_contig``, then ``vcf2smc``, then the
folded rows) runs here at 200 kbp.
"""

import gzip
import importlib.util
import logging
import os

import numpy as np
import pytest

from smcpp_tpu.commands import main as jax_main
from smcpp_tpu_torch.commands import main as torch_main

LENGTH = 200_000
SAMPLES = [f"s{i}" for i in range(8)]
GTS = ["0|0", "0|1", "1|0", "1|1", "0/1", "1/1", "./.", ".|1", "0|.", "0|0:35",
       "1|0:12:x"]


def _write_vcf(path, seed, contig_header=True):
    """A seeded VCF of contig "1" (and records of contigs "2" and "10")."""
    rng = np.random.RandomState(seed)
    samples = SAMPLES
    pos = np.sort(rng.choice(np.arange(1, LENGTH + 1), 400, replace=False))
    pos = np.sort(np.r_[pos, rng.choice(pos, 6, replace=False)])  # duplicates
    lines = ["##fileformat=VCFv4.2"]
    if contig_header:
        lines += ["##contig=<ID=10,length=99>",
                  f"##contig=<ID=1,length={LENGTH}>",
                  f"##contig=<ID=2,length={LENGTH}>"]
    lines.append("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                            "FILTER", "INFO", "FORMAT", *samples]))
    p = np.array([0.5, 0.15, 0.15, 0.12, 0.02, 0.02, 0.01, 0.01, 0.01, 0.005,
                  0.005])
    for i, x in enumerate(pos):
        kind = rng.randint(20)
        ref, alt = "A", "G"
        if kind == 0:
            alt = "G,T"  # multi-allelic
        elif kind == 1:
            ref = "AT"  # indel
        elif kind == 2:
            alt = "."
        gts = rng.choice(GTS, size=len(samples), p=p / p.sum())
        if kind == 0:
            gts[rng.randint(len(samples))] = "1|2"
        contig = "1"
        if i % 50 == 7:
            contig = "2" if i % 100 == 7 else "10"
        lines.append("\t".join([contig, str(x), ".", ref, alt, ".", "PASS", ".",
                                "GT:DP", *gts]))
    text = "\n".join(lines) + "\n"
    if str(path).endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)
    return str(path)


def _text(fn):
    opener = gzip.open if str(fn).endswith(".gz") else open
    with opener(fn, "rt") as f:
        return f.read()


def _both(tmp_path, argv_of, out_name="out.smc.gz"):
    """Run both CLIs; returns (JAX text, port text).  ``argv_of(out)`` gives
    the arguments for the output path ``out``."""
    got = []
    for tag, main in (("jax", jax_main.main), ("torch", torch_main.main)):
        out = tmp_path / f"{tag}_{out_name}"
        main(["vcf2smc", *argv_of(str(out))])
        got.append(_text(out))
    return got


@pytest.fixture(scope="module")
def vcfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcf")
    rng = np.random.RandomState(3)
    starts = np.sort(rng.choice(np.arange(0, LENGTH - 2000, 2000), 12,
                                replace=False))
    bed = "".join(f"1\t{s}\t{s + rng.randint(10, 1900)}\n" for s in starts)
    bed += "2\t5\t90\n"
    with open(d / "mask.bed", "w") as f:
        f.write(bed)
    with gzip.open(d / "mask.bed.gz", "wt") as f:
        f.write(bed)
    beds = [str(d / "mask.bed"), str(d / "mask.bed.gz")]
    with open(d / "pop1.txt", "w") as f:
        f.write("\n".join(SAMPLES[:4]) + "\n")
    with open(d / "pop2.txt", "w") as f:
        f.write("\n".join(SAMPLES[4:]) + "\n")
    return {
        "vcf": _write_vcf(d / "a.vcf", 1),
        "vcf_gz": _write_vcf(d / "b.vcf.gz", 2),
        "headless": _write_vcf(d / "c.vcf", 4, contig_header=False),
        "beds": beds,
        "lists": (f"@{d / 'pop1.txt'}", f"@{d / 'pop2.txt'}"),
    }


POP1 = "pop1:" + ",".join(SAMPLES[:4])
POP2 = "pop2:" + ",".join(SAMPLES[4:])
POP_ALL = "pop1:" + ",".join(SAMPLES)

CASES = {
    "one_pop": lambda v, o: [v["vcf"], o, "1", POP_ALL],
    "one_pop_gz_in": lambda v, o: [v["vcf_gz"], o, "1", POP_ALL],
    "two_pops": lambda v, o: [v["vcf"], o, "1", POP1, POP2],
    "d_in_pop1": lambda v, o: ["-d", "s2", "s2", v["vcf"], o, "1", POP_ALL],
    "d_across_pops": lambda v, o: ["-d", "s1", "s6", v["vcf"], o, "1", POP1,
                                   POP2],
    "d_second_in_pop2": lambda v, o: ["-d", "s0", "s5", v["vcf"], o, "1", POP1,
                                      POP2],
    "mask_bed": lambda v, o: ["--mask", v["beds"][0], v["vcf"], o, "1", POP_ALL],
    "mask_bed_gz": lambda v, o: ["-m", v["beds"][1], v["vcf"], o, "1", POP1,
                                 POP2],
    "missing_cutoff": lambda v, o: ["--missing-cutoff", "300", v["vcf"], o, "1",
                                    POP_ALL],
    "drop_first_last": lambda v, o: ["--drop-first-last", v["vcf"], o, "1",
                                     POP_ALL],
    "ignore_missing": lambda v, o: ["--ignore-missing", v["vcf"], o, "1",
                                    POP_ALL + ",nobody"],
    "sample_lists": lambda v, o: [v["vcf"], o, "1", "pop1:" + v["lists"][0],
                                  "pop2:" + v["lists"][1]],
    "length_flag": lambda v, o: ["--length", str(LENGTH + 777), v["headless"],
                                 o, "1", POP_ALL],
    "length_flag_over_header": lambda v, o: ["-l", str(LENGTH + 5), v["vcf"], o,
                                             "1", POP_ALL],
    "other_contig": lambda v, o: [v["vcf"], o, "2", POP1, POP2],
}


@pytest.mark.parametrize("out_name", ["out.smc.gz", "out.smc"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vcf2smc_matches_jax(vcfs, tmp_path, case, out_name):
    jtext, ttext = _both(tmp_path, lambda o: CASES[case](vcfs, o), out_name)
    assert ttext == jtext
    rows = np.array([r.split() for r in ttext.splitlines()[1:]], dtype=np.int64)
    assert len(rows) > 3
    if case == "missing_cutoff":
        assert (rows[:, 1] == -1).any()


def test_vcf2smc_case_coverage(vcfs, tmp_path):
    """The parametrised VCF holds every kind of record the cases rely on,
    and the folding and the masks show in the output."""
    text = _text(vcfs["vcf"])
    recs = [r.split("\t") for r in text.splitlines() if not r.startswith("#")]
    assert any("," in r[4] for r in recs)
    assert any(len(r[3]) > 1 for r in recs)
    assert any(r[4] == "." for r in recs)
    assert any(r[0] != "1" for r in recs)
    assert any("." in g.split(":")[0] for r in recs for g in r[9:])
    pos = [r[1] for r in recs if r[0] == "1"]
    assert len(pos) > len(set(pos))
    _, masked = _both(tmp_path, lambda o: CASES["mask_bed"](vcfs, o))
    rows = np.array([r.split() for r in masked.splitlines()[1:]], np.int64)
    assert (rows[:, 1] == -1).sum() >= 10
    assert rows[:, 0].sum() == LENGTH + 12  # BED ends inclusive, as in JAX


def test_vcf2smc_duplicate_warning_matches_jax(vcfs, tmp_path, caplog):
    msgs = {}
    for tag, main in (("jax", jax_main.main), ("torch", torch_main.main)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            main(["vcf2smc", vcfs["vcf"], str(tmp_path / f"{tag}.smc"), "1",
                  POP_ALL])
        msgs[tag] = [r.getMessage() for r in caplog.records
                     if r.name.endswith("data.vcf")]
    assert msgs["torch"] == msgs["jax"]
    assert msgs["torch"] and msgs["torch"][0].startswith("Multiple entries at ")


ERRORS = {
    "mask_and_cutoff": lambda v, o: ["-m", v["beds"][0], "-c", "100", v["vcf"],
                                     o, "1", POP_ALL],
    "no_length": lambda v, o: [v["headless"], o, "1", POP_ALL],
    "unknown_sample": lambda v, o: [v["vcf"], o, "1", POP_ALL + ",nobody"],
    "unknown_distinguished": lambda v, o: ["-d", "s0", "nobody", v["vcf"], o,
                                           "1", POP_ALL],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_vcf2smc_errors_match_jax(vcfs, tmp_path, case):
    errs = []
    for tag, main in (("jax", jax_main.main), ("torch", torch_main.main)):
        with pytest.raises(RuntimeError) as e:
            main(["vcf2smc", *ERRORS[case](vcfs, str(tmp_path / f"{tag}.smc"))])
        errs.append(str(e.value))
    assert errs[1] == errs[0]


def test_sample_list_parse_error_matches_jax():
    from smcpp_tpu.commands import vcf2smc as jv
    from smcpp_tpu_torch.commands import vcf2smc as tv

    for x in ("nocolon", "a:b:c"):
        msgs = []
        for mod in (jv, tv):
            with pytest.raises(Exception) as e:
                mod.sample_list(x)
            msgs.append((type(e.value).__name__, str(e.value)))
        assert msgs[1] == msgs[0]
    assert tv.sample_list("p:a,b") == ("p", ["a", "b"])


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [90, 91])
def test_phase9_vcf_round_trip(tmp_path, seed):
    """chip_smoke's phase 9 at 200 kbp: simulated rows written as a VCF come
    back from the port's vcf2smc as the same rows with every (2, 18) site
    folded to (0, 0); the JAX package's vcf2smc writes the same text."""
    cs = _chip_smoke()
    out, n_rec, _ = cs.vcf_round_trip(str(tmp_path), "1", 200_000, seed)
    assert n_rec > 100
    pop = "pop1:" + ",".join(f"s{i}" for i in range(cs.FRONTEND_SAMPLES))
    jout = str(tmp_path / "jax.smc.gz")
    jax_main.main(["vcf2smc", str(tmp_path / "chr1.vcf.gz"), jout, "1", pop])
    assert _text(jout) == _text(out)


def test_phase9_vcf_writer_places_every_allele(tmp_path):
    """write_vcf: one record per segregating row, s0's genotype from a, b
    derived alleles over s1-s9, and the (2, 18) rows folded by vcf2smc."""
    cs = _chip_smoke()
    data = np.array([[5, 0, 0, 18], [1, 1, 3, 18], [1, 2, 18, 18],
                     [3, 0, 0, 18], [1, 0, 7, 18], [1, 2, 0, 18]])
    fn = str(tmp_path / "x.vcf.gz")
    assert cs.write_vcf(fn, "7", data, 12, seed=1) == 4
    recs = [r.split("\t") for r in _text(fn).splitlines() if r[0] != "#"]
    assert [int(r[1]) for r in recs] == [6, 7, 11, 12]
    for r, (a, b) in zip(recs, [(1, 3), (2, 18), (0, 7), (2, 0)]):
        haps = [int(h) for g in r[9:] for h in g.split("|")]
        assert sum(haps[:2]) == a and sum(haps[2:]) == b
    out = str(tmp_path / "x.smc")
    torch_main.main(["vcf2smc", fn, out, "7",
                     "pop1:" + ",".join(f"s{i}" for i in range(10))])
    assert cs.check_vcf2smc(out, data, 12) == 5
