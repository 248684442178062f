"""VCF -> SMC++ format conversion (pure Python).

Port of smcpp_tpu/data/vcf.py, which follows the converter of SMC++
(smcpp/commands/vcf2smc.py): biallelic SNPs only, span run-length coding,
distinguished-pair genotype ``a`` (-1 if missing), undistinguished derived
count ``b`` of ``nb`` non-missing, non-polymorphic folding, BED-mask /
missing-cutoff interleave.  pysam is not required: the VCF is streamed as
(gzipped) text, one record at a time.
"""

import gzip
import json
import logging
import re
from collections import namedtuple

import numpy as np

from ..version import version
from .format import RepeatingWriter, optional_gzip

logger = logging.getLogger(__name__)

SampleList = namedtuple("SampleList", "pid samples")

_GT_SPLIT = re.compile(r"[/|]")


def _parse_gt(field):
    "GT string -> tuple of allele indices (None for missing)."
    gt = field.split(":", 1)[0]
    return tuple(
        None if x in (".", "") else int(x) for x in _GT_SPLIT.split(gt)
    )


def _iter_vcf(fn, contig):
    "Yield (pos, alleles, {sample: gt tuple}) for records on ``contig``."
    opener = gzip.open if str(fn).endswith(".gz") else open
    header_len = None
    samples = None
    with opener(fn, "rt") as f:
        for line in f:
            if line.startswith("##"):
                yield ("meta", line.rstrip("\n"), None)
                continue
            if line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                samples = cols[9:]
                yield ("samples", samples, None)
                continue
            cols = line.rstrip("\n").split("\t")
            if cols[0] != str(contig):
                continue
            pos = int(cols[1])
            ref, alt = cols[3], cols[4]
            alleles = [ref] + ([] if alt in (".", "") else alt.split(","))
            gts = cols[9:]
            yield ("rec", (pos, alleles), gts)


def vcf2smc(
    vcf_path,
    out_path,
    contig,
    pop1,
    pop2=SampleList(None, []),
    distinguished=None,
    length=None,
    missing_cutoff=None,
    mask=None,
    drop_first_last=False,
    ignore_missing=False,
):
    "Convert one contig of a VCF to the SMC++ format.  Returns the out path."
    if missing_cutoff and mask:
        raise RuntimeError("missing_cutoff and mask are mutually exclusive")

    pops = [pop1] + ([pop2] if pop2.pid is not None else [])
    npop = len(pops)
    if distinguished is None:
        distinguished = [pop1.samples[0]] * 2
    d_pairs = [(distinguished[0], 0), (distinguished[1], 1)]
    dist = [[], []]
    for sid, i in d_pairs:
        if sid in pop1.samples:
            dist[0].append((sid, i))
        elif pop2.pid is not None and sid in pop2.samples:
            dist[1].append((sid, i))
        else:
            raise RuntimeError(f"{sid} is not in the sample list")
    undist = [
        [(k, i) for k in p.samples for i in (0, 1) if (k, i) not in dd]
        for p, dd in zip(pops, dist)
    ]
    dist = dist[:npop]

    # stream the VCF: the header (##contig length, #CHROM sample columns)
    # always precedes the records, so after consuming it the records can be
    # converted one at a time — nothing is accumulated in memory, and
    # arbitrarily large VCFs convert in O(1) space.
    it = _iter_vcf(vcf_path, contig)
    contig_length = length
    samples = None
    for kind, payload, gts in it:
        if kind == "meta":
            if contig_length is None and payload.startswith("##contig"):
                m = re.search(r"ID=([^,>]+)", payload)
                ln = re.search(r"length=(\d+)", payload)
                if m and ln and m.group(1) == str(contig):
                    contig_length = int(ln.group(1))
        elif kind == "samples":
            samples = payload
            break
        else:
            raise RuntimeError("VCF record before the #CHROM header line")
    if contig_length is None:
        raise RuntimeError("Could not determine contig length; pass length=")
    if samples is None:
        raise RuntimeError("VCF has no sample columns")
    sample_col = {s: i for i, s in enumerate(samples)}
    missing = [s for u in undist for s, _ in u if s not in sample_col]
    if missing:
        if not ignore_missing:
            raise RuntimeError(f"Samples not found in data: {missing}")
        undist = [[t for t in u if t[0] not in missing] for u in undist]

    nb_tot = [len(u) for u in undist]
    na = [len(d) for d in dist]
    abnb_miss = [-1, 0, 0] * npop
    abnb_nonseg = [x for n in nb_tot for x in (0, 0, n)]

    if mask:
        mask_iter = []
        with optional_gzip(mask, "rt") as mf:
            for line in mf:
                p = line.split("\t")
                if p[0] == str(contig):
                    mask_iter.append((p[0], int(p[1]), int(p[2])))
        missing_cutoff = np.inf
    else:
        mask_iter = []
        if missing_cutoff is None:
            missing_cutoff = np.inf

    def rec2gt(payload, gts):
        pos, alleles = payload
        parsed = {}

        def gt_of(sid):
            if sid not in parsed:
                parsed[sid] = _parse_gt(gts[sample_col[sid]])
            return parsed[sid]

        a = []
        for di in dist:
            alle = [gt_of(s)[i] for s, i in di]
            a.append(-1 if None in alle else sum(x != 0 for x in alle))
        b, nb = [], []
        for un in undist:
            vals = [gt_of(s)[i] for s, i in un]
            nonmiss = [v for v in vals if v is not None]
            b.append(sum(v != 0 for v in nonmiss))
            nb.append(len(nonmiss))
        if b == nb and a == na:
            a = [0] * len(a)
            b = [0] * len(b)
        return [x for t in zip(a, b, nb) for x in t]

    def snps():
        "Remaining records of the open VCF stream, biallelic SNPs only."
        for kind, payload, gts in it:
            if kind != "rec":
                continue
            if len(payload[1]) <= 2 and all(len(al) == 1 for al in payload[1]):
                yield payload, gts

    def interleaved():
        mi = iter(mask_iter)
        si = snps()
        cmask = next(mi, None)
        csnp = next(si, None)
        while cmask or csnp:
            if cmask is None:
                yield "snp", csnp
                csnp = next(si, None)
            elif csnp is None:
                yield "mask", cmask
                cmask = next(mi, None)
            else:
                pos = csnp[0][0]
                if pos < cmask[1]:
                    yield "snp", csnp
                    csnp = next(si, None)
                elif pos < cmask[2]:
                    while csnp is not None and csnp[0][0] < cmask[2]:
                        csnp = next(si, None)
                    yield "mask", cmask
                    cmask = next(mi, None)
                else:
                    yield "mask", cmask
                    cmask = next(mi, None)

    with optional_gzip(out_path, "wt") as out:
        pids = [p.pid for p in pops]
        out.write("# SMC++ ")
        json.dump(
            {
                "version": version,
                "pids": pids,
                "undist": [[list(t) for t in u] for u in undist],
                "dist": [[list(t) for t in d] for d in dist],
            },
            out,
        )
        out.write("\n")
        with RepeatingWriter(out) as rw:
            first = [True]

            def write(x):
                if not first[0] or not drop_first_last:
                    rw.write(x)
                first[0] = False

            last_pos = 0
            seen_multiple = set()
            for ty, rec in interleaved():
                if ty == "mask":
                    span = rec[1] - last_pos
                    write([span] + abnb_nonseg)
                    write([rec[2] - rec[1] + 1] + abnb_miss)
                    last_pos = rec[2]
                    continue
                payload, gts = rec
                pos = payload[0]
                if pos == last_pos:
                    seen_multiple.add(pos)
                    continue
                abnb = rec2gt(payload, gts)
                span = pos - last_pos - 1
                if 1 <= span <= missing_cutoff:
                    write([span] + abnb_nonseg)
                elif span > missing_cutoff:
                    write([span] + abnb_miss)
                write([1] + abnb)
                last_pos = pos
            if not drop_first_last:
                write([contig_length - last_pos] + abnb_nonseg)
        if seen_multiple:
            logger.warning(
                "Multiple entries at %d positions; kept the first",
                len(seen_multiple),
            )
    return out_path
