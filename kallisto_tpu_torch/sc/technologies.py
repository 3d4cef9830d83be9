"""Single-cell technology definitions: barcode/UMI/sequence substrings.

Mirrors the reference's built-in technology table and the custom `-x
bc,start,stop:umi,start,stop:seq,start,stop` mini-DSL
(reference: src/main.cpp:1283-1445 table, 700-800 ParseTechnology).

A substring is (fileno, start, stop); stop == 0 means "to end of read";
fileno == -1 means "absent" (no barcode / no UMI).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Substr = Tuple[int, int, int]


@dataclass
class BusOptions:
    nfiles: int
    seq: List[Substr]
    umi: List[Substr]
    bc: List[Substr]
    paired: bool = False
    strand: Optional[str] = None     # implied default strandedness
    # custom `-x bc:RX:seq` strings: the UMI lives in the FASTQ comment as an
    # RX:Z: SAM tag (reference: src/main.cpp:857-859, BUSOptions
    # keep_fastq_comments, src/common.h:47)
    keep_fastq_comments: bool = False

    def bc_length(self) -> int:
        """Total fixed barcode length, 0 if any piece is open-ended
        (reference: BUSOptions::getBCLength, src/common.h:62-76)."""
        total = 0
        for f, a, b in self.bc:
            if f == -1 or b == 0:
                return 0
            total += b - a
        return total

    def umi_length(self) -> int:
        total = 0
        for f, a, b in self.umi:
            if f == -1 or b == 0:
                return 0
            total += b - a
        return total


def _t(nfiles, seq, umi, bc, paired=False, strand=None) -> BusOptions:
    return BusOptions(nfiles=nfiles, seq=seq, umi=umi, bc=bc,
                      paired=paired, strand=strand)


TECHNOLOGIES = {
    # reference: src/main.cpp:1283-1408
    "10XV2": _t(2, [(1, 0, 0)], [(0, 16, 26)], [(0, 0, 16)], strand="fr"),
    "10XV3": _t(2, [(1, 0, 0)], [(0, 16, 28)], [(0, 0, 16)], strand="fr"),
    "VISIUM": _t(2, [(1, 0, 0)], [(0, 16, 28)], [(0, 0, 16)], strand="fr"),
    "10XV1": _t(3, [(2, 0, 0)], [(1, 0, 10)], [(0, 0, 14)], strand="fr"),
    "SURECELL": _t(
        2, [(1, 0, 0)], [(0, 51, 59)],
        [(0, 0, 6), (0, 21, 27), (0, 42, 48)], strand="fr",
    ),
    "DROPSEQ": _t(2, [(1, 0, 0)], [(0, 12, 20)], [(0, 0, 12)]),
    "INDROPSV1": _t(2, [(1, 0, 0)], [(0, 42, 48)], [(0, 0, 11), (0, 30, 38)]),
    "INDROPSV2": _t(2, [(0, 0, 0)], [(1, 42, 48)], [(1, 0, 11), (1, 30, 38)]),
    "INDROPSV3": _t(3, [(2, 0, 0)], [(1, 8, 14)], [(0, 0, 8), (1, 0, 8)]),
    "CELSEQ": _t(2, [(1, 0, 0)], [(0, 8, 12)], [(0, 0, 8)], strand="fr"),
    "CELSEQ2": _t(2, [(1, 0, 0)], [(0, 0, 6)], [(0, 6, 12)], strand="fr"),
    "SPLIT-SEQ": _t(
        2, [(0, 0, 0)], [(1, 0, 10)],
        [(1, 10, 18), (1, 48, 56), (1, 78, 86)], strand="fr",
    ),
    "STORM-SEQ": _t(
        2, [(0, 0, 0), (1, 14, 0)], [(1, 0, 8)], [(-1, -1, -1)],
        paired=True, strand="rf",
    ),
    "SCRBSEQ": _t(2, [(1, 0, 0)], [(0, 6, 16)], [(0, 0, 6)]),
    "SMARTSEQ3": _t(
        4, [(2, 22, 0), (3, 0, 0)], [(2, 0, 19)], [(0, 0, 0), (1, 0, 0)],
        paired=True, strand="fr",
    ),
    "SMARTSEQ2": _t(
        4, [(2, 0, 0), (3, 0, 0)], [(-1, -1, -1)], [(0, 0, 0), (1, 0, 0)],
        paired=True,
    ),
    # reference arithmetic: CLS1 9 / linker 12 / CLS2 9 / linker 13 / CLS3 9 / UMI 8
    "BDWTA": _t(
        2, [(1, 0, 0)], [(0, 9 + 12 + 9 + 13 + 9, 9 + 12 + 9 + 13 + 9 + 8)],
        [(0, 0, 9), (0, 9 + 12, 9 + 12 + 9),
         (0, 9 + 12 + 9 + 13, 9 + 12 + 9 + 13 + 9)],
        strand="fr",
    ),
    "VASA-SEQ": _t(1, [(0, 14, 0)], [(0, 0, 6)], [(0, 6, 14)], strand="fr"),
}


TECHNOLOGY_LIST = [
    "10XV1", "10XV2", "10XV3", "VISIUM", "Bulk", "BDWTA", "CELSEQ",
    "CELSEQ2", "DROPSEQ", "INDROPSV1", "INDROPSV2", "INDROPSV3", "SCRBSEQ",
    "SMARTSEQ2", "SMARTSEQ3", "SPLIT-SEQ", "STORM-SEQ", "SURECELL",
    "VASA-SEQ",
]


def parse_technology(
    tech: str, single_end: bool = False, paired: bool = False
) -> BusOptions:
    """Resolve a technology name or a custom `-x` string.

    Custom format: `bc,start,stop[,...]:umi,start,stop:seq,start,stop[,...]`
    written as `fileno,start,stop` triplets separated by `,` within a
    section and `:` between bc/umi/seq sections; `-1,-1,-1` marks an
    absent section.  Suffixes `%FORWARD`/`%REVERSE`/`%PAIRED` override
    strandedness/pairing (reference: main.cpp:680-698).
    """
    name = tech.upper()
    strand_override = None
    paired_override = False
    for suffix, action in (
        ("%FORWARD", "fr"), ("%REVERSE", "rf"), ("%UNSTRANDED", None),
    ):
        if name.endswith(suffix):
            strand_override = action
            name = name[: -len(suffix)]
    if name.endswith("%PAIRED"):
        paired_override = True
        name = name[: -len("%PAIRED")]

    if name == "BULK":
        # regular RNA-seq through the BUS machinery: whole read(s) are the
        # sequence, no barcode/UMI; each input file (or pair) is a batch
        # with a fake barcode (reference: main.cpp:1050-1220,
        # ProcessReads.cpp:1606-1610)
        if paired or paired_override:
            return BusOptions(
                nfiles=2, seq=[(0, 0, 0), (1, 0, 0)],
                umi=[(-1, -1, -1)], bc=[(-1, -1, -1)], paired=True,
                strand=strand_override,
            )
        return BusOptions(
            nfiles=1, seq=[(0, 0, 0)], umi=[(-1, -1, -1)],
            bc=[(-1, -1, -1)], paired=False, strand=strand_override,
        )

    if name in TECHNOLOGIES:
        b = TECHNOLOGIES[name]
        bus = BusOptions(
            nfiles=b.nfiles, seq=list(b.seq), umi=list(b.umi), bc=list(b.bc),
            paired=b.paired or paired_override,
            strand=strand_override if strand_override is not None else b.strand,
        )
        if name == "SMARTSEQ2" and single_end:
            bus.nfiles = 3
            bus.seq = [(2, 0, 0)]
            bus.paired = False
        return bus

    # custom string: sections bc:umi:seq, each a list of fileno,start,stop
    sections = tech.split(":")
    if len(sections) != 3:
        raise ValueError(f"unable to create technology: {tech}")

    def parse_section(s: str) -> List[Substr]:
        nums = [int(x) for x in s.split(",")]
        if len(nums) % 3 != 0 or not nums:
            raise ValueError(f"unable to create technology: {tech}")
        return [tuple(nums[i : i + 3]) for i in range(0, len(nums), 3)]

    bc = parse_section(sections[0])
    # `RX` as the UMI section: extract the UMI from the RX:Z: SAM tag in the
    # FASTQ comment (reference: src/main.cpp:857-859)
    keep_comments = sections[1].strip().upper() == "RX"
    umi = [(-1, -1, -1)] if keep_comments else parse_section(sections[1])
    seq = parse_section(sections[2])
    nfiles = max(f for sub in (bc + umi + seq) for f in [sub[0]]) + 1
    paired = paired_override or (len(seq) == 2 and not single_end)
    return BusOptions(
        nfiles=nfiles, seq=seq, umi=umi, bc=bc, paired=paired,
        strand=strand_override, keep_fastq_comments=keep_comments,
    )
