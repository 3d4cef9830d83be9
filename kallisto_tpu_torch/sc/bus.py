"""`kallisto bus` equivalent: single-cell BUS record generation.

reference: BUSProcessor::processBuffer (src/ProcessReads.cpp:1380-1832),
MasterProcessor::update BUS branch (602-628), batch-mode round-robin
(371-405), main.cpp bus dispatch + finalize (2336-2617), BUS binary
format (src/BUSData.h:30-38, src/BUSTools.cpp).

Input surface:
- technology runs (`-x 10xv2 R1 R2 ...`),
- batch runs (`-B batch.txt`, with or without `-x`; `--batch-barcodes`),
- bulk runs (`-x bulk`, each file/pair its own batch with a fake barcode),
- interleaved FASTQ (`--inleaved`),
- BAM input (`-b`, CR/UR tags),
- 5' UMI tag detection (`-T`, SMARTSEQ3 default tag),
- RX:Z UMI-in-comment custom technologies (`-x bc:RX:seq`),
- long reads (`--long`/`--threshold`).

Port of kallisto_tpu/sc/bus.py.  Barcode/UMI extraction and 2-bit packing
are vectorized host numpy; the cDNA sequence goes through the card and
host EC resolution as in quant.  A uniform-length chunk takes the two-wave
anchor kernel I (ops/anchor.py; JAX bus.py:899-951), any other chunk
kernel A per read; kernel B then
gives each read's 128-bit key and, for pairs, its mapPair fragment length
in one launch.  `--aa` runs kernel A on each of the six frames.  Records
are emitted in read order with EC ids assigned at first-seen; the
reference's per-8MB-fetch [known-EC..., new-EC...] record grouping is
replayed byte-exactly (_FetchEmulator).

`BusResult.timings` holds host seconds by span (utils/spans.py; `bus.<name>`
on a profiler's timeline; see run_bus), chunks by route:
`anchor` (resolved from kernel I's results), `full` (kernel A per read;
every chunk of --aa) and `fallback` (chunks with reads of more than R
distinct EC rows, re-resolved on the host), and kernel I's wave-2 reads
(`wave2_reads`).  Kernel I has no wave-2 capacity, so an anchor chunk is
never redone per read, where the JAX package redoes one whose failures
exceed its capacity (the outputs are the same).

`--long` (JAX bus.py:1229-1291) sends every chunk through kernel J and the
long-read resolver of quant (quant/longread.py); novel reads go to
novel.fastq uncounted, and flens.txt holds the per-target mean read
length of the uniquely mapped reads, with the reference's batch-mode
discard of it kept.  Its chunks count as `long`.

`bus -t N` (JAX bus.py:781-792, :1131-1170): with more than one shard
(parallel/mesh.py) every chunk goes per read, kernel A on each shard's
device, the shards' results concatenated in mesh order; the anchor route
is skipped, and --aa and --long keep one device, as in JAX.  The outputs
are those of one device.
"""

import os
import struct
import sys
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .. import KALLISTO_COMPAT_VERSION, resolve_device
from ..common import MAX_FRAG_LEN, Options, REFERENCE_INDEX_VERSION
from ..index import load_index, save_index
from ..io import writers
from ..io.fastx import (
    BASE_CODE,
    FastqStream,
    ReadBatch,
    _read_batch_to_packed,
    single_batches,
)
from ..ops import anchor
from ..ops.pseudoalign import (
    KeySpec,
    SideResult,
    pseudoalign_batch_packed,
    pseudoalign_long_packed,
    read_keys,
    to_device,
    upload_batch,
)
from ..ops.turbo import _split, make_aux
from ..parallel.mesh import MeshRunner, make_mesh, n_shards
from ..quant.ecmap import EcResolver
from ..quant.filters import StrandFilter
from ..quant.longread import resolve_long_reads
from ..quant.pipeline import (
    _apply_overflow_fallback,
    _bucket_size,
    _exemplar_fetcher,
    _pad_rows,
    _turbo_exceptions,
    _uniform_len,
)
from ..utils import spans
from ..utils.spans import span
from .technologies import BusOptions, parse_technology

BUS_VERSION = 1
BUS_HEADER_TEXT = b"BUS file produced by kallisto"
BUSFORMAT_FAKE_BARCODE_LEN = 16  # reference: src/BUSTools.h:9
# run_bus's phase spans: timings["unspanned_s"] is the part of the run
# that none of them covers
_PHASES = ("index_upload", "read", "extract", "pseudoalign", "resolve",
           "write")
SMARTSEQ3_TAG = "ATTGCGCAATG"    # reference: src/main.cpp:1448


def _log(msg: str, end: str = "\n"):
    print(msg, file=sys.stderr, end=end, flush=True)


def write_bus_header(f, bclen: int, umilen: int) -> None:
    """reference: writeBUSHeader (src/BUSTools.cpp:5-14)."""
    f.write(b"BUS\x00")
    f.write(struct.pack("<III", BUS_VERSION, bclen, umilen))
    f.write(struct.pack("<I", len(BUS_HEADER_TEXT)))
    f.write(BUS_HEADER_TEXT)


def pack_dna_binary(codes: np.ndarray, lens: np.ndarray):
    """Vectorized stringToBinary (reference: src/BUSData.cpp:8-36).

    codes: [B, L] base codes (4 = N/other, packed as G).  Returns
    (binary uint64 [B], flag uint32 [B]); positions >= lens are ignored.
    flag = (min(numN,3) & 3) | (first N position & 31) << 2.
    """
    B, L = codes.shape
    k = np.minimum(lens, 32)
    pos = np.arange(L)[None, :]
    active = pos < k[:, None]
    bits = np.where(codes == 4, 2, codes).astype(np.uint64)
    shift = (k[:, None] - 1 - pos).astype(np.int64)
    contrib = np.where(active, bits << np.maximum(shift, 0).astype(np.uint64) * np.uint64(2), 0)
    r = contrib.sum(axis=1, dtype=np.uint64)
    isN = active & (codes == 4)
    numN = np.minimum(isN.sum(axis=1), 3).astype(np.uint32)
    first_n = np.where(isN.any(axis=1), isN.argmax(axis=1), 0).astype(np.uint32)
    flag = np.where(numN > 0, (numN & 3) | ((first_n & 31) << 2), 0).astype(np.uint32)
    return r, flag


def hamming2(a: np.ndarray, b: int, length: int) -> np.ndarray:
    """Per-position hamming distance over 2-bit packed DNA
    (reference: src/BUSData.cpp:56-68)."""
    df = a ^ np.uint64(b)
    d = np.zeros(a.shape, np.int32)
    for i in range(length):
        d += ((df >> np.uint64(2 * i)) & np.uint64(3)) != 0
    return d


def _extract_substrs(
    batches: List[ReadBatch], substrs, max_out: int
):
    """Concatenate technology substrings across files, vectorized.

    Returns (codes [B, max_out], lens [B], ok [B]); lens is the TRUE
    (uncapped) concatenated length -- stringToBinary packs only the first
    32 bases but histograms/conditions use the true length (reference:
    ProcessReads.cpp:1594-1617).  ok=False means a required substring
    exceeded the read (reference 'bad umi/bc' skip).
    """
    B = batches[0].n
    out = np.full((B, max_out), 4, np.uint8)
    out_len = np.zeros(B, np.int64)   # true concatenated length
    ok = np.ones(B, bool)
    for fileno, start, stop in substrs:
        rb = batches[fileno]
        l = rb.lens.astype(np.int64)
        sublen = np.where(stop == 0, l - start, stop - start)
        good = (l >= start + sublen) & (sublen > 0)
        ok &= good
        write_off = np.minimum(out_len, max_out)
        writable = np.clip(max_out - write_off, 0, None)
        maxsub = int(min(max(sublen.max(initial=0), 0), max_out))
        if maxsub > 0:
            src = rb.codes[:, start : start + maxsub]
            if src.shape[1] < maxsub:
                src = np.concatenate(
                    [src, np.full((B, maxsub - src.shape[1]), 4, np.uint8)],
                    axis=1,
                )
            # scatter src rows into out at per-read offsets
            col = np.arange(maxsub)[None, :]
            take = col < np.minimum(sublen, writable)[:, None]
            dst_col = write_off[:, None] + col
            valid = take & (dst_col < max_out) & good[:, None]
            rowi = np.broadcast_to(np.arange(B)[:, None], dst_col.shape)
            out[rowi[valid], dst_col[valid]] = src[valid]
        out_len = out_len + np.where(good, sublen, 0)
    return out, out_len.astype(np.int32), ok


def _extract_seq(
    batches: List[ReadBatch], seq_substrs, start_override=None
) -> ReadBatch:
    """Build the cDNA sequence batch: a single substring slice, or multiple
    substrings joined by an N separator (reference: ProcessReads.cpp:1549-1580).

    start_override: optional list (parallel to seq_substrs) of per-read
    int start vectors (or None), used by the UMI-tag path where non-tag
    reads start at `umi.start - taglen` (ProcessReads.cpp:1550-1563)."""
    if len(seq_substrs) == 1:
        fileno, start, stop = seq_substrs[0]
        rb = batches[fileno]
        l = rb.lens.astype(np.int64)
        sv = None if start_override is None else start_override[0]
        if sv is None:
            sublen = np.where(stop == 0, l - start, np.minimum(stop, l) - start)
            sublen = np.maximum(sublen, 0)
            codes = rb.codes[:, start:] if stop == 0 else rb.codes[:, start:stop]
            return ReadBatch(codes=np.ascontiguousarray(codes), lens=sublen.astype(np.int32))
        sublen = np.where(stop == 0, l - sv, np.minimum(stop, l) - sv)
        sublen = np.maximum(sublen, 0)
        W = int(sublen.max(initial=0))
        col = sv[:, None] + np.arange(W)[None, :]
        col_c = np.minimum(col, rb.codes.shape[1] - 1)
        codes = rb.codes[np.arange(rb.n)[:, None], col_c]
        codes[np.arange(W)[None, :] >= sublen[:, None]] = 4
        return ReadBatch(codes=codes, lens=sublen.astype(np.int32))
    total = sum(
        (batches[f].codes.shape[1] - a if b == 0 else b - a) + 1
        for f, a, b in seq_substrs
    )
    codes, lens, _ = _extract_substrs_with_sep(
        batches, seq_substrs, total, start_override
    )
    return ReadBatch(codes=codes, lens=lens)


def _extract_substrs_with_sep(batches, substrs, max_out, start_override=None):
    B = batches[0].n
    out = np.full((B, max_out), 4, np.uint8)
    out_len = np.zeros(B, np.int32)
    for si, (fileno, start, stop) in enumerate(substrs):
        rb = batches[fileno]
        l = rb.lens.astype(np.int64)
        sv = None if start_override is None else start_override[si]
        if sv is None:
            sv = np.full(B, start, np.int64)
        sublen = np.clip(np.where(stop == 0, l - sv, stop - sv), 0, None)
        maxsub = int(min(sublen.max(initial=0), max_out))
        if maxsub > 0:
            col = sv[:, None] + np.arange(maxsub)[None, :]
            col_c = np.minimum(col, rb.codes.shape[1] - 1)
            src = rb.codes[np.arange(B)[:, None], col_c]
            take = np.arange(maxsub)[None, :] < sublen[:, None]
            dst_col = out_len[:, None] + np.arange(maxsub)[None, :]
            valid = take & (dst_col < max_out)
            rowi = np.broadcast_to(np.arange(B)[:, None], dst_col.shape)
            out[rowi[valid], dst_col[valid]] = src[valid]
            out_len = (out_len + np.minimum(sublen, max_out - out_len)).astype(np.int32)
        # 'N' separator after each piece (reference appends 'N')
        sep_ok = out_len < max_out
        out[np.arange(B)[sep_ok], out_len[sep_ok]] = 4
        out_len = out_len + sep_ok.astype(np.int32)
    return out, out_len, np.ones(B, bool)


# -- input configuration ---------------------------------------------------


@dataclass
class BatchSpec:
    """One input batch: a cell/sample with its own file set and fake-barcode
    index (reference: opt.batch_ids/batch_files + MP.batch_id_mapping,
    src/main.cpp:1056-1170, src/ProcessReads.h:211-224)."""

    name: str
    files: List[str]
    bc_index: int


@dataclass
class BusRunConfig:
    bus: BusOptions
    batches: List[BatchSpec]
    batch_mode: bool
    no_technology: bool     # batch route without -x (bulk-like)
    record_batch: bool      # --batch-barcodes
    tagseq: str
    interleaved: bool
    bam: bool
    long_read: bool
    threshold: float
    strand: Optional[str]
    single_end: bool


def _parse_batch_file(path: str) -> Tuple[List[str], List[List[str]]]:
    """Parse a `-B` batch file: `id file1 [file2 ...]` lines, `#` comments
    (reference: CheckOptionsBus, src/main.cpp:1124-1175, 1235-1270)."""
    ids: List[str] = []
    file_lists: List[List[str]] = []
    ncols = None
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            ids.append(parts[0])
            files = parts[1:]
            if ncols is None:
                ncols = len(files)
            if len(files) != ncols or ncols == 0:
                raise ValueError("batch file malformatted")
            for fn in files:
                if not os.path.exists(fn):
                    raise FileNotFoundError(fn)
            file_lists.append(files)
    if not ids:
        raise ValueError("batch file malformatted")
    return ids, file_lists


def _batch_id_mapping(ids: List[str]) -> List[int]:
    """Duplicate batch ids share one fake barcode
    (reference: src/ProcessReads.h:211-224)."""
    seen = {}
    out = []
    for i in ids:
        if i not in seen:
            seen[i] = len(seen)
        out.append(seen[i])
    return out


def _configure(opt: Options) -> BusRunConfig:
    """Resolve the bus input surface into one run configuration
    (reference: CheckOptionsBus, src/main.cpp:926-1530)."""
    tech = opt.technology.strip()
    base = tech.split("%")[0].upper()
    no_technology = tech == "" or base == "BULK"

    if opt.inleaved:
        if opt.bam:
            raise ValueError(
                "interleaved input is not compatible with the bam option"
            )
        if opt.batch_file:
            raise ValueError(
                "interleaved input cannot be specified with a batch file"
            )
        if len(opt.files) > 1:
            raise ValueError(
                "interleaved input cannot consist of more than one input"
            )
    if opt.batch_file and opt.files:
        raise ValueError("cannot specify batch mode and supply read files")

    if no_technology:
        # bulk-like batch route (reference: main.cpp:1050-1220)
        if opt.bam:
            raise ValueError("--bam not supported in this mode")
        if opt.tag:
            raise ValueError("--tag not supported in this mode")
        # --aa only supports single-end reads (reference: main.cpp:760-768)
        single_end = opt.single_end or opt.long_read or opt.aa
        # %PAIRED/%FORWARD/%REVERSE suffixes on "bulk"
        strand = opt.strand
        if tech and "%" in tech:
            for suf, s in (("%FORWARD", "fr"), ("%REVERSE", "rf")):
                if suf in tech.upper() and strand is None:
                    strand = s
        if getattr(opt, "unstranded", False):
            strand = None
        batches: List[BatchSpec] = []
        if opt.batch_file:
            ids, file_lists = _parse_batch_file(opt.batch_file)
            ncols = len(file_lists[0])
            if ncols not in (1, 2):
                raise ValueError("batch file malformatted")
            single_end = ncols == 1
            mapping = _batch_id_mapping(ids)
            batches = [
                BatchSpec(i, fl, m)
                for i, fl, m in zip(ids, file_lists, mapping)
            ]
        elif opt.inleaved:
            batches = [BatchSpec("batch0", [opt.files[0]], 0)]
            single_end = False
        else:
            step = 1 if single_end else 2
            if not single_end and len(opt.files) % 2 != 0:
                raise ValueError(
                    "paired-end mode requires an even number of input files"
                )
            batches = [
                BatchSpec(f"batch{j}", opt.files[i : i + step], j)
                for j, i in enumerate(range(0, len(opt.files), step))
            ]
        paired = not single_end and not opt.long_read
        seq = [(0, 0, 0)] + ([(1, 0, 0)] if paired else [])
        bus = BusOptions(
            nfiles=2 if paired else 1, seq=seq, umi=[(-1, -1, -1)], bc=[],
            paired=paired, strand=strand,
        )
        return BusRunConfig(
            bus=bus, batches=batches, batch_mode=True, no_technology=True,
            record_batch=opt.batch_barcodes, tagseq="",
            interleaved=opt.inleaved, bam=False, long_read=opt.long_read,
            threshold=opt.threshold, strand=strand, single_end=single_end,
        )

    bus = parse_technology(tech, opt.single_end, paired=opt.bus_paired)
    tagseq = opt.tag
    if not tagseq and base == "SMARTSEQ3":
        tagseq = SMARTSEQ3_TAG
        _log(f"[bus] Using {tagseq} as UMI tag sequence")
    if tagseq:
        # expand the first UMI substring to cover the tag
        # (reference: main.cpp:1467-1470)
        f0, a0, b0 = bus.umi[0]
        if f0 == -1:
            raise ValueError("technology has no UMI for --tag")
        a0 += len(tagseq)
        if a0 >= b0 and b0 != 0:
            raise ValueError("Tag sequence longer than UMI start position")
        bus.umi[0] = (f0, a0, b0)

    strand = opt.strand if opt.strand is not None else bus.strand
    if getattr(opt, "unstranded", False):
        strand = None

    if opt.long_read:
        bus.paired = False

    batch_mode = bool(opt.batch_file)
    if batch_mode:
        ids, file_lists = _parse_batch_file(opt.batch_file)
        if len(file_lists[0]) != bus.nfiles:
            raise ValueError(
                f"Wrong number of files per batch for technology: {tech}"
            )
        mapping = _batch_id_mapping(ids)
        batches = [
            BatchSpec(i, fl, m) for i, fl, m in zip(ids, file_lists, mapping)
        ]
    else:
        if opt.bam or opt.inleaved:
            if len(opt.files) != 1:
                raise ValueError("expected a single input file")
        elif len(opt.files) % bus.nfiles != 0:
            raise ValueError(
                f"number of files must be a multiple of {bus.nfiles} for "
                "this technology"
            )
        batches = [BatchSpec("", list(opt.files), -1)]
    return BusRunConfig(
        bus=bus, batches=batches, batch_mode=batch_mode, no_technology=False,
        record_batch=opt.batch_barcodes, tagseq=tagseq,
        interleaved=opt.inleaved, bam=opt.bam, long_read=opt.long_read,
        threshold=opt.threshold, strand=strand, single_end=opt.single_end,
    )


# -- input streams ---------------------------------------------------------


def _fastq_group_stream(
    files: List[str], nfiles: int, batch_reads: int, keep_comments: bool
) -> Iterator[Tuple[List[ReadBatch], Optional[List[bytes]]]]:
    """Yield aligned per-slot ReadBatch lists for files taken nfiles at a
    time (reference: FastqSequenceReader round-robin, ProcessReads.cpp:3163)."""
    for gi in range(0, len(files), nfiles):
        group = files[gi : gi + nfiles]
        streams = [
            single_batches(
                f, batch_reads,
                keep_comments=keep_comments and j == nfiles - 1,
            )
            for j, f in enumerate(group)
        ]
        while True:
            batches = [next(s, None) for s in streams]
            if any(b is None for b in batches):
                if not all(b is None for b in batches):
                    raise ValueError(
                        "technology FASTQ files have different record counts"
                    )
                break
            if any(b.n != batches[0].n for b in batches):
                raise ValueError(
                    "technology FASTQ files have different record counts"
                )
            # comments of the LAST slot: the reference's RX:Z extraction
            # indexes umis[] after the i += incf advance, which lands on the
            # final file of the group (ProcessReads.cpp:1470-1476, 1495)
            yield batches, batches[-1].comments


def _interleaved_stream(
    path: str, nfiles: int, batch_reads: int, keep_comments: bool
) -> Iterator[Tuple[List[ReadBatch], Optional[List[bytes]]]]:
    """De-interleave one FASTQ into nfiles virtual slots
    (reference: the interleave_nfiles hack, ProcessReads.cpp:3194-3199)."""
    s = FastqStream(path, keep_comments=keep_comments)
    try:
        while True:
            b = s.next_batch(batch_reads * nfiles)
            if b is None:
                return
            m = (b.n // nfiles) * nfiles
            if m == 0:
                return
            slots = [
                ReadBatch(
                    codes=np.ascontiguousarray(b.codes[j:m:nfiles]),
                    lens=b.lens[j:m:nfiles],
                )
                for j in range(nfiles)
            ]
            comments = (
                b.comments[nfiles - 1 : m : nfiles] if b.comments else None
            )
            yield slots, comments
    finally:
        s.close()


def _bam_stream(
    path: str, batch_reads: int
) -> Iterator[Tuple[List[ReadBatch], Optional[List[bytes]]]]:
    """BAM input: each primary record becomes a (CR+UR tags, sequence)
    virtual read pair consumed by the technology's substring extraction
    (reference: BamSequenceReader, src/ProcessReads.h:114-172,
    src/ProcessReads.cpp:3316-3391)."""
    from ..io.bam import FSECONDARY, read_bam

    _, _, _, records = read_bam(path)
    bc_chunks: List[np.ndarray] = []
    seq_chunks: List[np.ndarray] = []

    def flush():
        out = ([_pad_stack(bc_chunks), _pad_stack(seq_chunks)], None)
        bc_chunks.clear()
        seq_chunks.clear()
        return out

    for rec in records:
        if rec.flag & FSECONDARY:  # secondary alignments are skipped
            continue
        cr = rec.aux_get(b"CR") or ""
        ur = rec.aux_get(b"UR") or ""
        bcumi = (cr + ur).encode()
        bc_chunks.append(BASE_CODE[np.frombuffer(bcumi, np.uint8)])
        seq_chunks.append(rec.seq_codes)
        if len(bc_chunks) >= batch_reads:
            yield flush()
    if bc_chunks:
        yield flush()


def _pad_stack(rows: List[np.ndarray]) -> ReadBatch:
    lens = np.array([r.shape[0] for r in rows], np.int32)
    W = int(lens.max(initial=1))
    out = np.full((len(rows), W), 4, np.uint8)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return ReadBatch(codes=out, lens=lens)


# -- results ---------------------------------------------------------------


@dataclass
class BusResult:
    num_processed: int
    num_pseudoaligned: int
    num_unique: int
    bclen: int
    umilen: int
    ec_sets: List[np.ndarray]
    counts: np.ndarray
    flens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    timings: dict = field(default_factory=dict)


def _binary_to_string(val: int, length: int) -> str:
    """reference: binaryToString (src/BUSData.cpp:38-49)."""
    return "".join(
        "ACGT"[(val >> (2 * (length - 1 - i))) & 3] for i in range(length)
    )


_BUS_REC_DT = np.dtype(
    [("barcode", "<u8"), ("UMI", "<u8"), ("ec", "<i4"),
     ("count", "<u4"), ("flags", "<u4"), ("pad", "<u4")]
)


def _build_records(read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
                   read_numbers=None):
    """Assemble BUS records for mapped reads, in read order.  With -n the
    flags column holds the global read number instead
    (reference: ProcessReads.cpp:1747-1749)."""
    mapped = np.flatnonzero(read_ec >= 0)
    recs = np.zeros(mapped.size, dtype=_BUS_REC_DT)
    gsel = sel[mapped]
    recs["barcode"] = bc_bin[gsel]
    recs["UMI"] = umi_bin[gsel]
    recs["ec"] = read_ec[mapped]
    recs["count"] = 1
    if read_numbers is not None:
        recs["flags"] = read_numbers[gsel]
    else:
        recs["flags"] = bc_flag[gsel] | (umi_flag[gsel] << 8)
    return recs


class _FetchEmulator:
    """Replays the reference's per-8MB-fetch record grouping byte-exactly.

    The reference worker writes each fetch's records as [known-EC records
    in read order, then new-EC records in read order], where "known" means
    the EC was already promoted into index.ecmapinv -- promotion happens
    per fetch under the adaptive transfer_threshold (start 1, +1 up to 4,
    then *1.25; reference: MasterProcessor::update + attempt_transfer_ecs,
    src/ProcessReads.cpp:436-478, 575-628, ProcessReads.h:177).  EC *ids*
    are first-seen read order either way; only the within-fetch record
    order and the barcode/UMI length-histogram cutoff (first >=10k reads,
    per fetch, src/ProcessReads.cpp:575-587) depend on fetch boundaries.

    Fetch boundaries follow the reference's 8MB read buffer: a read group
    costs nfiles + sum(l_i) bytes and a fetch ends when the next group
    would reach the limit (src/ProcessReads.cpp:3178-3199; interleaved
    input stops 256KB early at a group boundary).
    """

    BUFSIZE = 1 << 23          # reference: ProcessReads.h:178
    _INTERLEAVE_SLACK = 262144  # reference: ProcessReads.cpp:3196

    def __init__(self, busf, run, interleaved: bool = False):
        self.busf = busf
        self.run = run
        self.interleaved = interleaved
        self.bufpos = 0
        self.watermark = 0          # ECs promoted into "index.ecmapinv"
        self.ecs_total = 0          # ECs assigned by flushed fetches
        self.threshold = 1
        self._recs: List[np.ndarray] = []
        self._bc_hist = np.zeros(33, np.int64)
        self._umi_hist = np.zeros(33, np.int64)

    def add_chunk(
        self,
        costs: np.ndarray,         # [B] per-group buffer cost
        group_of_rec: np.ndarray,  # [n_recs] group index of each record
        recs: np.ndarray,          # [n_recs] structured BUS records
        bc_hist_val: np.ndarray,   # [B] barcode length or -1
        umi_hist_val: np.ndarray,  # [B] UMI length or -1
        bound_costs: Optional[np.ndarray] = None,  # interleaved: first-record cost
    ):
        """Feed one processed chunk; splits it at emulated fetch boundaries.

        A group is accepted while bufpos + bound_cost < limit (strict,
        reference: ProcessReads.cpp:3192); the overflowing group starts the
        next fetch.  bound_costs defaults to costs (non-interleaved: the
        boundary check value equals the full group cost)."""
        B = costs.shape[0]
        if bound_costs is None:
            bound_costs = costs
        lim = self.BUFSIZE - (
            self._INTERLEAVE_SLACK if self.interleaved else 0
        )
        lo = 0
        while lo < B:
            cum = self.bufpos + np.cumsum(costs[lo:]) \
                - costs[lo:] + bound_costs[lo:]
            fits = cum < lim
            n_take = int(fits.argmin()) if not fits.all() else B - lo
            if n_take == 0:
                if self.bufpos == 0:
                    n_take = 1  # oversized single group: accept anyway
                else:
                    self.flush()
                    continue
            hi = lo + n_take
            m = (group_of_rec >= lo) & (group_of_rec < hi)
            self._recs.append(recs[m])
            for h, v in ((self._bc_hist, bc_hist_val[lo:hi]),
                         (self._umi_hist, umi_hist_val[lo:hi])):
                vv = v[(v >= 0) & (v <= 32)]
                np.add.at(h, vv, 1)
            self.bufpos += int(costs[lo:hi].sum())
            lo = hi
            if lo < B:
                self.flush()

    def flush(self):
        """End of one emulated fetch: write records grouped [known, new],
        run the transfer dynamics, merge the length histograms."""
        self.bufpos = 0
        if not self._recs:
            return
        recs = np.concatenate(self._recs)
        self._recs = []
        run = self.run
        # histogram cutoff: stop merging once both sums passed 10k
        if (run.bc_len_hist.sum() < 10000 or run.umi_len_hist.sum() < 10000):
            run.bc_len_hist += self._bc_hist
            run.umi_len_hist += self._umi_hist
        self._bc_hist[:] = 0
        self._umi_hist[:] = 0
        if recs.size:
            known = recs["ec"] < self.watermark
            self.busf.write(recs[known].tobytes())
            self.busf.write(recs[~known].tobytes())
            run.num_emitted += recs.size
            hi = int(recs["ec"].max()) + 1
        else:
            hi = 0
        new_total = max(self.ecs_total, hi)
        num_new = new_total - self.ecs_total
        self.ecs_total = new_total
        if num_new >= self.threshold:
            actual = self.ecs_total - self.watermark
            if actual >= self.threshold:
                self.watermark = self.ecs_total
                if self.threshold <= 4:
                    self.threshold += 1
                else:
                    self.threshold = int(self.threshold * 1.25)


def _side_rows(didx, pb, k: int, dev) -> SideResult:
    """Kernel A on one packed batch (the per-read route)."""
    return pseudoalign_batch_packed(didx, *upload_batch(pb, dev), k=k, L=pb.Lp)


def _host_side(r: SideResult, n: int) -> SideResult:
    """Host copy of the first n reads' fields (drops padding reads)."""
    return SideResult(*(t[:n] for t in r)).to_numpy()


def _process_aa_frames(seq1, didx, index, k, resolver, aa_resolver, dev):
    """6-frame comma-free-code pseudoalignment + best-frame selection
    (reference: BUSProcessor aa frames, src/ProcessReads.cpp:1653-1694;
    MinCollector::intersectKmersCFC, src/MinCollector.cpp:44-119).

    Frames: forward +0/+1/+2, then reverse-complement +0/+1/+2.  A read
    whose ANY frame intersects an off-list (D-list) target is discarded;
    otherwise the frame with the smallest non-empty on-list EC wins (first
    frame wins ties; ties are counted as cardinality clashes).
    """
    from ..utils.cfc import nt_to_cfc_codes, revcomp_codes

    codes, lens = seq1.codes, seq1.lens
    B = codes.shape[0]
    rc = revcomp_codes(codes, lens)
    num_onlist = index.num_onlist

    frame_idx = []    # per frame: [B] index into that frame's uniq list
    frame_sets = []   # per frame: list of (masked_set|None)
    frame_off = []    # per frame: [B] bool off-list member present
    frame_card = []   # per frame: [B] cardinality of masked set (0 = none)
    for src in (codes, rc):
        for fr in range(3):
            fc, fl = nt_to_cfc_codes(src, lens, fr)
            pb = _read_batch_to_packed(ReadBatch(codes=fc, lens=fl), k)
            r1 = _side_rows(didx, pb, k, dev)
            h = read_keys(r1, None, k)[0].cpu().numpy()
            s1 = r1.to_numpy()
            uidx, usets = aa_resolver.resolve_batch_hashed(
                h, _exemplar_fetcher(r1, None, KeySpec()),
                int(r1.rows.shape[1]), paired=False,
            )
            _apply_overflow_fallback(
                aa_resolver, index, uidx, usets, False, (s1, pb), None,
            )
            off = np.array(
                [s is not None and bool((s >= num_onlist).any()) for s in usets]
            )
            masked = [
                None if s is None or s[s < num_onlist].size == 0
                else s[s < num_onlist]
                for s in usets
            ]
            card = np.array(
                [0 if m is None else m.shape[0] for m in masked], np.int64
            )
            frame_idx.append(uidx)
            frame_sets.append(masked)
            frame_off.append(off[uidx] if off.size else np.zeros(B, bool))
            frame_card.append(card[uidx])

    veto = np.zeros(B, bool)
    for off in frame_off:
        veto |= off
    cards = np.stack(frame_card)                      # [6, B]
    cards_inf = np.where(cards > 0, cards, np.iinfo(np.int64).max)
    winner = np.argmin(cards_inf, axis=0)             # first frame wins ties
    any_hit = (cards > 0).any(axis=0)
    ok = any_hit & ~veto

    # assemble (final_idx, final_sets) for count_batch
    final_sets = []
    offsets = []
    for fs in frame_sets:
        offsets.append(len(final_sets))
        final_sets.extend(fs)
    none_slot = len(final_sets)
    final_sets.append(None)
    final_idx = np.full(B, none_slot, np.int64)
    for f in range(6):
        m = ok & (winner == f)
        final_idx[m] = offsets[f] + frame_idx[f][m]
    return resolver.count_batch(final_idx, final_sets)


class _BusRun:
    """Single-run state for `kallisto bus` (histograms, per-batch FLDs,
    output stream) shared across input chunks."""

    def __init__(self, opt: Options, cfg: BusRunConfig, index, dev,
                 timings: dict):
        self.opt = opt
        self.cfg = cfg
        self.index = index
        self.k = index.k
        self.dev = dev
        self.timings = timings
        with span("index_upload", "index_upload_s"):
            # the shards (one, or several devices: chunks per read over
            # them), one index replica per distinct device; --aa and --long
            # keep one
            one = opt.aa or cfg.long_read
            self.mesh = MeshRunner(make_mesh(
                1 if one else n_shards(opt, dev), dev))
            self.dev = self.mesh.devices[0]
            self.didx = self.mesh.replicate(index)[0]
        self.resolver = EcResolver(index, dfk_onlist=opt.dfk_onlist)
        self.aa_resolver = (
            EcResolver(index, mask_offlist=False) if opt.aa else None
        )
        self.lr_resolver = (
            EcResolver(index, mask_offlist=False) if cfg.long_read else None
        )
        self.strand_filter = (
            StrandFilter(index, cfg.strand)
            if cfg.strand in ("fr", "rf") else None
        )
        bus = cfg.bus
        self.no_bc = (not bus.bc) or bus.bc[0][0] == -1
        self.no_umi = bus.umi[0][0] == -1 and not bus.keep_fastq_comments
        self.bulk_like = (
            (cfg.batch_mode and cfg.no_technology) or bus.umi[0][0] == -1
        ) and not bus.keep_fastq_comments

        self.tag_binary = 0
        self.taglen = len(cfg.tagseq)
        if cfg.tagseq:
            tcodes, tlens = _encode_one(cfg.tagseq)
            tb, _ = pack_dna_binary(tcodes, tlens)
            self.tag_binary = int(tb[0])

        os.makedirs(opt.output_dir, exist_ok=True)
        self.bus_path = os.path.join(opt.output_dir, "output.bus")
        self.busf = open(self.bus_path, "wb")
        self.tech_bclen = bus.bc_length()
        self.tech_umilen = bus.umi_length()
        # header (reference: MasterProcessor ctor, src/ProcessReads.h:235-254)
        if cfg.batch_mode:
            if cfg.no_technology:
                write_bus_header(self.busf, BUSFORMAT_FAKE_BARCODE_LEN, 1)
            elif cfg.record_batch and self.no_bc:
                write_bus_header(
                    self.busf, BUSFORMAT_FAKE_BARCODE_LEN, self.tech_umilen
                )
            else:
                write_bus_header(self.busf, self.tech_bclen, self.tech_umilen)
        else:
            write_bus_header(self.busf, self.tech_bclen, self.tech_umilen)

        self.bc_len_hist = np.zeros(33, np.int64)
        self.umi_len_hist = np.zeros(33, np.int64)
        self.emu = _FetchEmulator(self.busf, self, interleaved=cfg.interleaved)
        self.num_processed = 0
        self.num_emitted = 0
        self._progress_counter = 0
        self.progress_printed = False
        nb = len(cfg.batches)
        if cfg.batch_mode:
            self.flens = np.zeros((nb, MAX_FRAG_LEN), np.int64)
            self.tlencount = np.zeros(nb, np.int64)
        else:
            self.flens = np.zeros((1, MAX_FRAG_LEN), np.int64)
            self.tlencount = np.zeros(1, np.int64)
        # long-read per-target read-length sums (reference: flens_lr)
        T = index.target_lens.shape[0]
        self.flens_lr = np.zeros((nb if cfg.batch_mode else 1, T), np.int64)
        self.flens_lr_c = np.zeros((nb if cfg.batch_mode else 1, T), np.int64)
        self.tlencount_lr = 0
        self.novel_f = None
        if cfg.long_read:
            self.novel_f = open(
                os.path.join(opt.output_dir, "novel.fastq"), "w"
            )

    # -- progress (reference: MasterProcessor::update, ProcessReads.cpp:634-643)
    def _progress(self, n: int):
        self._progress_counter += n
        if self._progress_counter >= 1000000:
            self._progress_counter = 0
            pct = 100.0 * self.num_emitted / max(self.num_processed, 1)
            _log(
                f"\r[progress] {self.num_processed // 1000000}M reads "
                f"processed ({pct:5.1f}% mapped)             ",
                end="",
            )
            self.progress_printed = True

    def _chunk_costs(self, slots: List[ReadBatch]) -> np.ndarray:
        """Reference buffer cost per read group: nfiles + sum of lengths
        (src/ProcessReads.cpp:3178-3181; BAM: l_seq+l_bc+l_umi+2 which is
        the same formula over the two virtual reads, cpp:3337)."""
        cost = np.full(slots[0].n, len(slots), np.int64)
        for b in slots:
            cost += b.lens
        return cost

    def _emit(self, slots, read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
              read_numbers, bc_hist_val, umi_hist_val):
        """One chunk's BUS records into the output stream (the span
        `bus.write`, with the output files' final writes)."""
        with span("write", "write_s"):
            recs = _build_records(
                read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
                read_numbers
            )
            group_idx = (sel[read_ec >= 0] if sel.size
                         else np.empty(0, np.int64))
            bound = None
            if self.cfg.interleaved:
                # interleaved boundary check uses only the first record's
                # cost
                bound = 1 + slots[0].lens.astype(np.int64)
            self.emu.add_chunk(
                self._chunk_costs(slots), group_idx, recs,
                bc_hist_val, umi_hist_val, bound,
            )

    def _anchor_upload(self, sides):
        """(padded packed codes, aux, Bp, read length) on the card for the
        anchor kernel, or None when the chunk has no anchor route: mixed
        lengths, reads shorter than k, a length whose wave-2 row width has
        none (where the JAX package raises; ops/anchor.py row_width_ok), or
        more Ns than the aux vector holds."""
        rl = _uniform_len(*sides)
        if rl is None or not anchor.row_width_ok(rl, self.k):
            return None
        Bp = _bucket_size(sides[0].n, lo=1024)
        exc = _turbo_exceptions(sides, Bp)
        if exc is None:
            return None
        aux = make_aux(sides[0].n, rl, exc)
        if aux is None:
            return None
        packed = [to_device(_pad_rows(b.packed, Bp), self.dev, np.uint8)
                  for b in sides]
        return packed, to_device(aux, self.dev), Bp, rl

    def _anchor(self, sides):
        """Kernel I over a uniform-length chunk (ops/anchor.py): the
        SideResult of every read, mate 1 first, and the padded size; None
        when the chunk has no anchor route."""
        up = self._anchor_upload(sides)
        if up is None:
            return None
        packed, aux, Bp, rl = up
        side, n_fail = anchor.anchor_sides(
            self.didx, packed, aux, self.k, sides[0].Lp, 16,
            anchor.n_anchors_for(rl, self.k), rl)
        self.timings["anchor"] += 1
        self.timings["wave2_reads"] += int(n_fail)
        return side, Bp

    def _anchor_pair(self, b1, b2):
        """Fast path: the two-wave anchor kernel over a uniform-length
        chunk; None -> caller uses the per-read kernel (always over
        several shards)."""
        if b1.Lp != b2.Lp or self.mesh.ndev > 1:
            return None
        out = self._anchor((b1, b2))
        return None if out is None else _split(*out)

    def _anchor_single(self, b1):
        if self.mesh.ndev > 1:
            return None
        out = self._anchor((b1,))
        return None if out is None else out[0]

    # -- one chunk of reads from one batch --------------------------------
    def process_chunk(
        self,
        slots: List[ReadBatch],
        comments: Optional[List[bytes]],
        spec: BatchSpec,
        batch_idx: int,
        read_base: int,
    ):
        opt, cfg, bus = self.opt, self.cfg, self.cfg.bus
        with span("extract", "extract_s"):
            B = slots[0].n
            fl_slot = batch_idx if cfg.batch_mode else 0
            # the reference's n_processed counts every fetched read group,
            # including bad-UMI/barcode skips (MasterProcessor::update n,
            # ProcessReads.cpp:1372,636)
            self.num_processed += B

            # ---- UMI ----------------------------------------------------
            ignore_umi = np.zeros(B, bool)
            check_tag = bool(cfg.tagseq)
            if self.bulk_like:
                umi_bin = np.full(B, np.uint64(0xFFFFFFFFFFFFFFFF))
                umi_flag = np.zeros(B, np.uint32)
                umi_ok = np.ones(B, bool)
                ulen = np.ones(B, np.int32)
                ignore_umi[:] = True
            elif bus.keep_fastq_comments:
                # RX:Z UMI from the FASTQ comment
                # (reference: ProcessReads.cpp:1495-1503, 3228-3245)
                umi_strs = _extract_rx(comments, B)
                ulen = np.array(
                    [min(len(u), 32) for u in umi_strs], np.int32
                )
                umi_ok = ulen > 0
                W = max(int(ulen.max(initial=1)), 1)
                ucodes = np.full((B, W), 4, np.uint8)
                for i, u in enumerate(umi_strs):
                    if ulen[i]:
                        ucodes[i, : ulen[i]] = BASE_CODE[
                            np.frombuffer(u[: ulen[i]], np.uint8)
                        ]
                umi_bin, umi_flag = pack_dna_binary(ucodes, ulen)
            elif check_tag:
                # expand the UMI region to include the tag, then detect it
                # (reference: ProcessReads.cpp:1506-1544)
                f0, a0, b0 = bus.umi[0]
                l = slots[f0].lens.astype(np.int64)
                umilen0 = np.where(b0 == 0, l - a0, b0 - a0)
                umi_ok = (l >= a0 + umilen0) & (umilen0 > 0)
                full_len = (umilen0 + self.taglen).astype(np.int32)
                sv = np.full(B, a0 - self.taglen, np.int64)
                W = int(full_len.max(initial=1))
                col = sv[:, None] + np.arange(W)[None, :]
                col_c = np.clip(col, 0, slots[f0].codes.shape[1] - 1)
                ucodes = slots[f0].codes[np.arange(B)[:, None], col_c]
                ucodes[np.arange(W)[None, :] >= full_len[:, None]] = 4
                full_bin, umi_flag = pack_dna_binary(ucodes, full_len)
                # hamming over the tag prefix, 2-bit (BUSData.cpp:56-68);
                # distance 0 required for tags <= 5 bases, else <= 1
                ul = np.minimum(full_len, 32).astype(np.uint64)
                tag_part = full_bin >> (
                    np.uint64(2) * (ul - np.uint64(self.taglen))
                )
                ham = hamming2(tag_part, self.tag_binary, self.taglen)
                thr = 0 if self.taglen <= 5 else 1
                has_tag = (ham <= thr) & umi_ok
                umask = (np.uint64(1) << (
                    np.uint64(2) * (ul - np.uint64(self.taglen))
                )) - np.uint64(1)
                umi_bin = np.where(
                    has_tag, full_bin & umask, np.uint64(0xFFFFFFFFFFFFFFFF)
                )
                ignore_umi = ~has_tag
                ulen = np.where(has_tag, umilen0, 0).astype(np.int32)
            else:
                max_umi = 32
                ucodes, ulen, umi_ok = _extract_substrs(slots, bus.umi,
                                                        max_umi)
                umi_bin, umi_flag = pack_dna_binary(ucodes, ulen)

            if check_tag:
                # only tag-carrying (true UMI) reads enter the UMI histogram
                # (reference: ProcessReads.cpp:1530-1534)
                uok = umi_ok & ~ignore_umi & (ulen <= 32) & (ulen >= 0)
            else:
                uok = umi_ok & (ulen <= 32)
            umi_hist_val = np.where(uok, np.clip(ulen, 0, 32), -1)

            # ---- barcode ------------------------------------------------
            if self.no_bc:
                bc_flag = np.zeros(B, np.uint32)
                bc_ok = np.ones(B, bool)
                if cfg.batch_mode and (cfg.no_technology or cfg.record_batch):
                    # fake barcode identifying the batch
                    # (reference: ProcessReads.cpp:1604-1612)
                    bc_bin = np.full(B, spec.bc_index, np.uint64)
                else:
                    bc_bin = np.zeros(B, np.uint64)
                blen = np.full(B, BUSFORMAT_FAKE_BARCODE_LEN, np.int32)
            else:
                bcodes, blen, bc_ok = _extract_substrs(slots, bus.bc, 32)
                bc_bin, bc_flag = pack_dna_binary(bcodes, blen)

            good = umi_ok & bc_ok
            bok = good & (blen <= 32)
            bc_hist_val = np.where(bok, np.clip(blen, 0, 32), -1)

            if (cfg.batch_mode and not cfg.no_technology and cfg.record_batch
                    and not self.no_bc):
                # record batch in the barcode's upper bits
                # (reference: ProcessReads.cpp:1619-1627)
                bc_bin = (
                    np.uint64(spec.bc_index)
                    << (np.uint64(2) * np.minimum(blen, 32).astype(np.uint64))
                ) | bc_bin

            sel = np.flatnonzero(good)
            sub = [ReadBatch(codes=b.codes[sel], lens=b.lens[sel])
                   for b in slots]
            ignore_sel = ignore_umi[sel]

            # ---- cDNA sequence(s) ---------------------------------------
            # non-UMI (tag-less) reads start at umi.start - taglen when the
            # sequence shares the UMI's file (reference: ProcessReads.cpp:1550)
            def start_override(substrs):
                if not check_tag:
                    return None
                f0, a0, _ = bus.umi[0]
                out = []
                for fileno, start, stop in substrs:
                    if fileno == f0:
                        out.append(
                            np.where(ignore_sel, a0 - self.taglen,
                                     start).astype(np.int64)
                        )
                    else:
                        out.append(None)
                return out

            read_numbers = (
                read_base + np.arange(B, dtype=np.uint32) if opt.bus_num
                else None
            )

        if sel.size == 0:
            self._emit(
                slots, np.empty(0, np.int64), sel, bc_bin, umi_bin,
                bc_flag, umi_flag, None, bc_hist_val, umi_hist_val,
            )
            self._progress(B)
            return

        if opt.aa:
            seq1 = _extract_seq(
                sub, [bus.seq[0]] if bus.paired else bus.seq
            )
            read_ec, _ = _process_aa_frames(
                seq1, self.didx, self.index, self.k, self.resolver,
                self.aa_resolver, self.dev,
            )
            self.timings["full"] += 1
            self._emit(
                slots, read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
                read_numbers, bc_hist_val, umi_hist_val,
            )
            self._progress(B)
            return

        if cfg.long_read:
            self._process_long(
                slots, sub, sel, bc_bin, umi_bin, bc_flag, umi_flag,
                read_numbers, fl_slot, bc_hist_val, umi_hist_val,
            )
            self._progress(B)
            return

        with span("extract", "extract_s"):
            seq_subs = [bus.seq[0]] if bus.paired else bus.seq
            seq1 = _extract_seq(sub, seq_subs, start_override(seq_subs))
            b1p = _read_batch_to_packed(seq1, self.k)
            n = b1p.n
        with span("pseudoalign", "pseudoalign_s"):
            r2 = s2 = b2p = tl = None
            if bus.paired:
                so2 = start_override([bus.seq[1]])
                seq2 = _extract_seq(sub, [bus.seq[1]], so2)
                b2p = _read_batch_to_packed(seq2, self.k)
                fast = self._anchor_pair(b1p, b2p)
                if fast is not None:
                    r1, r2 = fast
                else:
                    self.timings["full"] += 1
                    r1 = self.mesh.pseudoalign_batch(b1p, self.k)
                    r2 = self.mesh.pseudoalign_batch(b2p, self.k)
                # kernel B: the key and the mapPair length in one launch
                h, tl, _ = read_keys(r1, r2, self.k)
                h = h[:n].cpu().numpy()
                tl = tl[:n].cpu().numpy()
                s1, s2 = _host_side(r1, n), _host_side(r2, n)
            else:
                fast = self._anchor_single(b1p)
                if fast is not None:
                    r1 = fast
                else:
                    self.timings["full"] += 1
                    r1 = self.mesh.pseudoalign_batch(b1p, self.k)
                h = read_keys(r1, None, self.k)[0][:n].cpu().numpy()
                s1 = _host_side(r1, n)
        with span("resolve", "resolve_s"):
            read_uidx, uniq_sets = self.resolver.resolve_batch_hashed(
                h, _exemplar_fetcher(r1, r2, KeySpec()),
                int(r1.rows.shape[1]), paired=bus.paired,
                do_union=opt.do_union,
            )
            _apply_overflow_fallback(
                self.resolver, self.index, read_uidx, uniq_sets,
                opt.do_union, (s1, b1p), (s2, b2p) if bus.paired else None,
            )
            ovf = s1.overflow | s2.overflow if bus.paired else s1.overflow
            if ovf.any():
                self.timings["fallback"] += 1

            final_idx, final_sets = read_uidx, uniq_sets
            if self.strand_filter is not None:
                # strand specificity is skipped for tag-less reads in tag
                # mode (doStrandSpecificityIfPossible,
                # ProcessReads.cpp:1536-1540)
                do_strand = (
                    ~ignore_sel if check_tag
                    else np.ones(sel.shape[0], bool)
                )
                if bus.paired:
                    final_idx, final_sets = self.strand_filter.apply_pair(
                        read_uidx, uniq_sets,
                        s1.has_hits & do_strand, s1.f_block, s1.f_strand,
                        s2.has_hits & do_strand, s2.f_block, s2.f_strand,
                    )
                else:
                    final_idx, final_sets = self.strand_filter.apply_pair(
                        read_uidx, uniq_sets,
                        s1.has_hits & do_strand, s1.f_block, s1.f_strand,
                    )

            read_ec, read_card = self.resolver.count_batch(final_idx,
                                                           final_sets)

            # fragment lengths: paired reads not carrying a UMI
            # (getFragLenIfPaired, reference: ProcessReads.cpp:1752-1762)
            if bus.paired and tl is not None:
                want = int(self.tlencount[fl_slot])
                if want < 10000:
                    okfl = (
                        (tl > 0) & (tl < MAX_FRAG_LEN) & (read_card == 1)
                        & s1.has_hits & s2.has_hits & (read_ec >= 0)
                    )
                    if check_tag:
                        okfl &= ignore_sel
                    take = np.flatnonzero(okfl)[: 10000 - want]
                    np.add.at(self.flens[fl_slot], tl[take], 1)
                    self.tlencount[fl_slot] += take.shape[0]

        self._emit(
            slots, read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
            read_numbers, bc_hist_val, umi_hist_val,
        )
        self._progress(B)

    def _process_long(
        self, slots, sub, sel, bc_bin, umi_bin, bc_flag, umi_flag,
        read_numbers, fl_slot, bc_hist_val, umi_hist_val,
    ):
        """Long-read bus (JAX bus.py:1229-1291): kernel J's exhaustive
        scan + modeECs + novelty threshold (reference:
        ProcessReads.cpp:1655-1664, 1680-1705, 1764-1776)."""
        bus = self.cfg.bus
        with span("extract", "extract_s"):
            seq1 = _extract_seq(sub, bus.seq)
            b1 = _read_batch_to_packed(seq1, self.k)
        with span("pseudoalign", "pseudoalign_s"):
            h = pseudoalign_long_packed(
                self.didx, *upload_batch(b1, self.dev), k=self.k, L=b1.Lp
            ).to_numpy()
            self.timings["long"] += 1
        with span("resolve", "resolve_s"):
            # novel reads are excluded from counting and written out
            final_sets, _, recs = resolve_long_reads(
                h, seq1.lens, self.cfg.threshold, self.lr_resolver,
                self.index.num_onlist, lambda r: seq1.codes[r])
            self.novel_f.write("".join(recs))
            B = seq1.lens.shape[0]
            final_idx = np.arange(B, dtype=np.int64)
            read_ec, read_card = self.resolver.count_batch(final_idx,
                                                           final_sets)

            # per-target read-length FLD for uniquely-mapping reads
            # (reference: ProcessReads.cpp:1764-1772; first 1M reads).  In
            # batch mode (incl. bulk) the reference's update() merges the
            # per-thread flens_lr the wrong way round and DISCARDS it
            # (src/ProcessReads.cpp:518-528: batchFlens_lr is only ever
            # added into the dying thread-local copy), so every batch-mode
            # run falls back to |target_len - k| in flens.txt; emulated
            # here for parity.
            if not self.cfg.batch_mode and self.tlencount_lr < 1000000:
                uniq = np.flatnonzero((read_card == 1) & (read_ec >= 0))
                uniq = uniq[: 1000000 - self.tlencount_lr]
                for r in uniq:
                    tr = final_sets[int(final_idx[r])]
                    self.flens_lr[fl_slot, tr[0]] += int(seq1.lens[r])
                    self.flens_lr_c[fl_slot, tr[0]] += 1
                self.tlencount_lr += uniq.shape[0]

        self._emit(
            slots, read_ec, sel, bc_bin, umi_bin, bc_flag, umi_flag,
            read_numbers, bc_hist_val, umi_hist_val,
        )


def _encode_one(s: str):
    codes = BASE_CODE[np.frombuffer(s.encode(), np.uint8)][None, :]
    return codes, np.array([len(s)], np.int32)


def _extract_rx(comments: Optional[List[bytes]], B: int) -> List[bytes]:
    """Extract RX:Z:<umi> from FASTQ comments
    (reference: ProcessReads.cpp:3228-3245)."""
    out = []
    for i in range(B):
        c = comments[i] if comments is not None and i < len(comments) else b""
        p = c.find(b"RX:Z:")
        if p < 0:
            out.append(b"")
            continue
        rest = c[p + 5:]
        for sep in (b" ", b"\t"):
            q = rest.find(sep)
            if q >= 0:
                rest = rest[:q]
        out.append(rest)
    return out


def run_bus(opt: Options, index=None, device=None) -> BusResult:
    """`kallisto bus` on `device` (default: the card; raises without one
    unless device='cpu')."""
    dev = resolve_device(device)
    # host wall seconds by span (utils/spans.py; `bus.<name>` on a
    # profiler's timeline): the whole run (run), index upload (index_upload;
    # index_prep_s its host gathers and casts), FASTQ/BAM read (read),
    # barcode/UMI and sequence extraction + packing (extract), upload +
    # kernels + fetch of keys and per-read fields (pseudoalign), EC
    # resolution + filters + counting (resolve), BUS record emission and
    # the output files (write), and what of the run none of them covers
    # (unspanned_s); then chunks by route (module docstring) and the
    # resolver's key-cache and native-key counters, as in run_quant
    timings = dict.fromkeys(
        ("run_s", "index_upload_s", "index_prep_s", "read_s", "extract_s",
         "pseudoalign_s", "resolve_s", "resolve_new_s", "write_s",
         "unspanned_s"), 0.0)
    timings.update(dict.fromkeys(
        ("anchor", "full", "fallback", "long", "wave2_reads",
         "ec_cache_lookups", "ec_cache_hits", "ec_native_keys"), 0))
    with spans.recording("bus", timings, _PHASES):
        return _run_bus(opt, index, dev, timings)


def _run_bus(opt: Options, index, dev, timings: dict) -> BusResult:
    start_time = time.strftime("%a %b %d %H:%M:%S %Y")
    if index is None:
        index = load_index(opt.index_path)
    cfg = _configure(opt)
    run = _BusRun(opt, cfg, index, dev, timings)
    bus = cfg.bus

    num_seen = 0
    capped = False
    for batch_idx, spec in enumerate(cfg.batches):
        if capped:
            break
        if cfg.bam:
            stream = _bam_stream(spec.files[0], opt.batch_size)
        elif cfg.interleaved:
            stream = _interleaved_stream(
                spec.files[0], bus.nfiles, opt.batch_size,
                bus.keep_fastq_comments,
            )
        else:
            stream = _fastq_group_stream(
                spec.files, bus.nfiles, opt.batch_size,
                bus.keep_fastq_comments,
            )
        # read numbering restarts per batch reader in batch mode
        # (FastqSequenceReader::numreads is per-reader)
        read_base = 0 if cfg.batch_mode else num_seen
        while True:
            with span("read", "read_s"):
                batch = next(stream, None)
            if batch is None:
                break
            slots, comments = batch
            B = slots[0].n
            if opt.max_num_reads and num_seen + B >= opt.max_num_reads:
                # downsample the final batch to exactly -N reads
                # (reference: ProcessReads.cpp:589-595)
                B = opt.max_num_reads - num_seen
                capped = True
                if B <= 0:
                    break
                slots = [
                    ReadBatch(codes=b.codes[:B], lens=b.lens[:B])
                    for b in slots
                ]
                comments = comments[:B] if comments is not None else None
            if not cfg.batch_mode:
                read_base = num_seen
            num_seen += B
            run.process_chunk(slots, comments, spec, batch_idx, read_base)
            if cfg.batch_mode:
                read_base += B
            if capped:
                break
        # a reader's final fetch ends with its stream; in batch mode the
        # EC transfer dynamics run between batches
        with span("write", "write_s"):
            run.emu.flush()

    with span("write", "write_s"):
        run.busf.close()
        if run.novel_f is not None:
            run.novel_f.close()
        if run.progress_printed:
            _log("")

        # barcode/UMI length detection + header back-patch: non-batch runs only
        # (reference: main.cpp:2472-2508)
        bclen = int(np.argmax(run.bc_len_hist))
        umilen = int(np.argmax(run.umi_len_hist))
        if not cfg.batch_mode:
            patch = False
            if run.tech_bclen == 0:
                patch = patch or bclen > 0
            else:
                bclen = run.tech_bclen
            if run.tech_umilen == 0:
                patch = patch or umilen > 0
            else:
                umilen = run.tech_umilen
            if patch:
                with open(run.bus_path, "r+b") as f:
                    f.seek(8)
                    f.write(struct.pack("<II", bclen, umilen))

        counts = run.resolver.counts_array()
        num_pseudoaligned = int(counts.sum())
        num_unique = run.resolver.num_unique_reads()

        # outputs (reference: main.cpp:2405-2596)
        out = opt.output_dir
        if cfg.batch_mode:
            with open(os.path.join(out, "matrix.cells"), "w") as f:
                for spec in cfg.batches:
                    f.write(f"{spec.name}\n")
            if cfg.no_technology or cfg.record_batch:
                with open(os.path.join(out, "matrix.sample.barcodes"),
                          "w") as f:
                    for spec in cfg.batches:
                        f.write(
                            _binary_to_string(
                                spec.bc_index, BUSFORMAT_FAKE_BARCODE_LEN
                            ) + "\n"
                        )
            if (not cfg.single_end or cfg.no_technology or bus.paired
                    or run.no_umi):
                save_index(index, os.path.join(out, "index.saved"))
            if not cfg.single_end or cfg.long_read:
                with open(os.path.join(out, "flens.txt"), "w") as f:
                    for bi in range(len(cfg.batches)):
                        if cfg.long_read:
                            f.write(_flens_lr_line(
                                run.flens_lr[bi], run.flens_lr_c[bi],
                                index.target_lens, index.k) + "\n")
                        else:
                            f.write(" ".join(str(int(x))
                                             for x in run.flens[bi]) + "\n")
        else:
            if bus.paired and not cfg.long_read:
                save_index(index, os.path.join(out, "index.saved"))
                with open(os.path.join(out, "flens.txt"), "w") as f:
                    f.write(" ".join(str(int(x)) for x in run.flens[0]) + "\n")
            elif cfg.long_read:
                save_index(index, os.path.join(out, "index.saved"))
                with open(os.path.join(out, "flens.txt"), "w") as f:
                    f.write(_flens_lr_line(
                        run.flens_lr[0], run.flens_lr_c[0],
                        index.target_lens, index.k) + "\n")
            elif run.no_umi:
                save_index(index, os.path.join(out, "index.saved"))
        writers.write_ec_list(
            os.path.join(out, "matrix.ec"), run.resolver.ec_sets
        )
        writers.write_transcripts(
            os.path.join(out, "transcripts.txt"),
            index.target_names[: index.num_onlist],
        )
        writers.write_run_info(
            os.path.join(out, "run_info.json"),
            n_targets=index.num_onlist,
            n_bootstraps=0,
            n_processed=run.num_processed,
            n_pseudoaligned=num_pseudoaligned,
            n_unique=num_unique,
            kallisto_version=KALLISTO_COMPAT_VERSION,
            index_version=REFERENCE_INDEX_VERSION,
            k=index.k,
            start_time=start_time,
            call=opt.call,
        )
    return BusResult(
        num_processed=run.num_processed,
        num_pseudoaligned=num_pseudoaligned,
        num_unique=num_unique,
        bclen=bclen,
        umilen=umilen,
        ec_sets=run.resolver.ec_sets,
        counts=counts,
        flens=run.flens[0],
        timings=timings,
    )


def _flens_lr_line(fld, fld_c, target_lens, k) -> str:
    """Per-target long-read FLD line: |mean(len) - k| for targets with
    uniquely-mapped reads, else |target_len - k|
    (reference: main.cpp:2427-2441, 2520-2530)."""
    vals = np.where(
        fld_c > 0.5,
        np.abs(fld / np.maximum(fld_c, 1) - k),
        np.abs(target_lens.astype(np.float64) - k),
    )
    return " ".join(f"{v:.6g}" for v in vals)
