"""Gene model: transcript -> gene mapping + GTF transcript models
(reference: src/GeneModel.{h,cpp}).

parse_gene_map covers the t2g path (parseGeneMap, GeneModel.cpp:580-632);
Transcriptome.parse_gtf is the full GTF model (parseGTF/addGTFLine,
GeneModel.cpp:268-577) used by quant-tcc -G and genomebam;
load_chromosomes and translate_tr_position project transcript
coordinates onto the genome for --genomebam.

A copy of kallisto_tpu/quant/genemodel.py.
"""

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class GeneMap:
    gene_names: List[str] = field(default_factory=list)      # first-seen order
    gene_common: List[str] = field(default_factory=list)
    tx_gene: np.ndarray = None   # [T] int32 gene id, -1 if unmapped

    @property
    def num_genes(self) -> int:
        return len(self.gene_names)


def parse_gene_map(path: str, target_names: Sequence[str]) -> GeneMap:
    """t2g file: `transcript<ws>gene_id[<ws>gene_common_name]` per line.

    Genes are numbered in first-appearance order
    (reference: Transcriptome::parseGeneMap, GeneModel.cpp:580-632).
    """
    tr_to_id: Dict[str, int] = {n: i for i, n in enumerate(target_names)}
    gm = GeneMap(tx_gene=np.full(len(target_names), -1, np.int32))
    gene_ids: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.split()
            txp = parts[0]
            if len(parts) < 2:
                raise ValueError(f"no gene associated with transcript {txp} in {path}")
            gene = parts[1]
            common = parts[2] if len(parts) > 2 else ""
            tid = tr_to_id.get(txp)
            if tid is None:
                raise ValueError(f"invalid transcript: {txp} in {path}")
            gid = gene_ids.get(gene)
            if gid is None:
                gid = len(gm.gene_names)
                gene_ids[gene] = gid
                gm.gene_names.append(gene)
                gm.gene_common.append(common)
            gm.tx_gene[tid] = gid
    return gm


@dataclass
class TranscriptModel:
    id: int = -1
    name: str = ""
    chr: int = -1
    gene_id: int = -1
    strand: bool = True
    start: int = 0
    stop: int = 0
    length: int = 0
    exons: List[Tuple[int, int]] = field(default_factory=list)


@dataclass
class GeneEntry:
    id: int = -1
    name: str = ""
    common_name: str = ""
    chr: int = -1
    strand: bool = True
    start: int = 0
    stop: int = 0


@dataclass
class TranscriptAlignment:
    chr: int = -1
    chrpos: int = -1
    strand: bool = True
    cigar: List[Tuple[int, str]] = field(default_factory=list)  # (len, op)


def _gtf_attributes(rest: str, want_keys):
    """Parse GTF `key "value";` attribute pairs, stopping once all wanted
    keys are seen (reference: addGTFLine attribute loop,
    src/GeneModel.cpp:352-411)."""
    out: Dict[str, str] = {}
    p = 0
    n = len(rest)
    while p < n:
        t = rest.find('"', p)
        if t < 0:
            break
        s = rest.find('"', t + 1)
        if s < 0:
            break
        key = rest[p : t - 1].strip()
        out[key] = rest[t + 1 : s]
        if want_keys.issubset(out.keys()):
            break
        p = rest.find(" ", s)
        if p < 0:
            break
        p += 1
    return out


class Transcriptome:
    """Transcript/gene/chromosome models from GTF or t2g files
    (reference: struct Transcriptome, src/GeneModel.h:86-106)."""

    def __init__(self, target_names: Sequence[str], target_lens: np.ndarray):
        self.transcripts: List[TranscriptModel] = [
            TranscriptModel(id=i, name=n) for i, n in enumerate(target_names)
        ]
        self.genes: List[GeneEntry] = []
        self.chr_names: List[str] = []
        self.chr_lens: List[int] = []
        self._target_lens = np.asarray(target_lens)
        self.tr_name_to_id: Dict[str, int] = {}
        for i, n in enumerate(target_names):
            self.tr_name_to_id.setdefault(n, i)
        self.gene_name_to_id: Dict[str, int] = {}
        self.chr_name_to_id: Dict[str, int] = {}

    # -- construction ------------------------------------------------------

    def load_chromosomes(self, path: str) -> None:
        """chrom.txt: `name length` per line
        (reference: Transcriptome::loadChromosomes, GeneModel.cpp:137-151)."""
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0]:
                    try:
                        ln = int(parts[1])
                    except ValueError:
                        continue
                    if ln >= 0 and parts[0] not in self.chr_name_to_id:
                        self.chr_name_to_id[parts[0]] = len(self.chr_names)
                        self.chr_names.append(parts[0])
                        self.chr_lens.append(ln)

    def parse_gtf(self, path: str, guess_chromosomes: bool = True) -> None:
        """reference: Transcriptome::parseGTF + addGTFLine
        (src/GeneModel.cpp:489-577, 268-488)."""
        import sys

        num_chrom_missing = 0
        num_trans_missing = 0
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            for line in f:
                r = self._add_gtf_line(line.rstrip("\n"), guess_chromosomes)
                if r == 1:
                    num_chrom_missing += 1
                elif r == 2:
                    num_trans_missing += 1
        if num_chrom_missing:
            print(
                f"Warning: could not find chromosomes for "
                f"{num_chrom_missing} transcripts", file=sys.stderr,
            )
        if num_trans_missing:
            print(
                f"Warning: {num_trans_missing} transcripts were defined in "
                "GTF file, but not in the index", file=sys.stderr,
            )

    def _add_gtf_line(self, line: str, guess_chromosomes: bool) -> int:
        if not line or line[0] == "#":
            return 0
        fields = line.split("\t", 8)
        if len(fields) < 9:
            return 0
        schr, _source, typestr, sstart, sstop, _score, sstrand, _phase, rest = fields
        if typestr not in ("gene", "transcript", "exon"):
            return 0
        start = int(sstart) - 1
        stop = int(sstop)
        strand = sstrand == "+"

        ichr = self.chr_name_to_id.get(schr, -1)
        if ichr == -1:
            if guess_chromosomes:
                # add on the fly with the largest bai-indexable length
                # (reference: addGTFLine, GeneModel.cpp:317-325)
                ichr = len(self.chr_names)
                self.chr_names.append(schr)
                self.chr_lens.append(536870911)
                self.chr_name_to_id[schr] = ichr
            else:
                return 1

        # early-stop once every key the reference counts is seen (keycount
        # break at 3/4, GeneModel.cpp:380-404); missing version keys simply
        # mean the whole attribute list is scanned
        want = (
            {"gene_id", "gene_version", "gene_name"} if typestr == "gene"
            else {"gene_id", "gene_version", "transcript_id",
                  "transcript_version"}
        )
        attrs = _gtf_attributes(rest, want)
        gene_name = attrs.get("gene_id", "")
        gversion = attrs.get("gene_version", "")

        if typestr == "gene":
            name = gene_name
            if gversion and "." not in name:
                name += "." + gversion
            g = GeneEntry(
                id=len(self.genes), name=name,
                common_name=attrs.get("gene_name", ""),
                chr=ichr, strand=strand, start=start, stop=stop,
            )
            self.gene_name_to_id.setdefault(g.name, g.id)
            self.genes.append(g)
            return 0

        transcript_name = attrs.get("transcript_id", "")
        tversion = attrs.get("transcript_version", "")
        tname = transcript_name
        if tversion and "." not in tname:
            tname += "." + tversion
        tid = self.tr_name_to_id.get(tname)
        if tid is None:
            tid = self.tr_name_to_id.get(transcript_name)

        if typestr == "transcript":
            if tid is None:
                return 2  # transcript in GTF but not in the index
            gname = gene_name
            if gversion:
                gname += "." + gversion
            gid = self.gene_name_to_id.get(gname)
            if gid is None:
                gid = self.gene_name_to_id.get(gene_name, -1)
            if self.transcripts[tid].chr == -1:
                self.transcripts[tid] = TranscriptModel(
                    id=tid, name=tname, chr=ichr, gene_id=gid, strand=strand,
                    start=start, stop=stop,
                    length=int(self._target_lens[tid]),
                )
        else:  # exon
            if tid is not None and self.transcripts[tid].chr != -1:
                self.transcripts[tid].exons.append((start, stop))
        return 0

    def parse_gene_map(self, path: str) -> None:
        """t2g into the full model (reference: Transcriptome::parseGeneMap,
        GeneModel.cpp:580-632)."""
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.split()
                txp = parts[0]
                if len(parts) < 2:
                    raise ValueError(
                        f"no gene associated with transcript {txp} in {path}"
                    )
                gene_name = parts[1]
                common = parts[2] if len(parts) > 2 else ""
                tid = self.tr_name_to_id.get(txp)
                if tid is None:
                    raise ValueError(f"invalid transcript: {txp} in {path}")
                gid = self.gene_name_to_id.get(gene_name)
                if gid is None:
                    gid = len(self.genes)
                    self.gene_name_to_id[gene_name] = gid
                    self.genes.append(
                        GeneEntry(id=gid, name=gene_name, common_name=common)
                    )
                self.transcripts[tid] = TranscriptModel(
                    id=tid, name=txp, gene_id=gid,
                    length=int(self._target_lens[tid]),
                )

    @property
    def tx_gene(self) -> np.ndarray:
        return np.array(
            [t.gene_id for t in self.transcripts], np.int32
        )

    # -- genome projection ---------------------------------------------------

    def translate_tr_position(
        self, tr: int, pos: int, rlen: int, strand: bool
    ) -> Optional[TranscriptAlignment]:
        """Project a transcript-coordinate alignment onto the genome with a
        spliced CIGAR (reference: Transcriptome::translateTrPosition,
        src/GeneModel.cpp:35-135)."""
        model = self.transcripts[tr]
        if model.chr == -1:
            return None
        aln = TranscriptAlignment(chr=model.chr, strand=(strand == model.strand))
        rpos = 0
        n_exons = len(model.exons)
        if model.strand:
            trpos = pos
            order = range(n_exons)
        else:
            trpos = model.length - pos - rlen
            order = range(n_exons - 1, -1, -1)
        if trpos < 0:
            aln.cigar.append((-trpos, "S"))
            rpos = -trpos
            aln.chrpos = model.start
        for idx, i in enumerate(order):
            start, stop = model.exons[i]
            ln = stop - start
            if trpos < ln:
                if rpos == 0:
                    aln.chrpos = start + trpos
                if trpos + rlen <= ln:
                    aln.cigar.append((rlen - rpos, "M"))
                    rpos = rlen
                    break
                mlen = ln if trpos < 0 else ln - trpos
                aln.cigar.append((mlen, "M"))
                if model.strand:
                    if i + 1 < n_exons:
                        aln.cigar.append(
                            (model.exons[i + 1][0] - stop, "N")
                        )
                else:
                    if i > 0:
                        aln.cigar.append((model.exons[i - 1][0] - stop, "N"))
                rpos += mlen
            trpos -= ln
        if rpos < rlen:
            aln.cigar.append((rlen - rpos, "S"))
        return aln


def rollup_to_genes(values: np.ndarray, tx_gene: np.ndarray, num_genes: int) -> np.ndarray:
    """Sum transcript-level values into genes (only alpha > 0 contributes,
    matching plaintext_writer_gene, PlaintextWriter.cpp:89-97 -- identical
    result since zeros add nothing)."""
    mask = tx_gene >= 0
    out = np.zeros(num_genes, np.float64)
    np.add.at(out, tx_gene[mask], values[mask])
    return out
