"""BAM/BGZF reading and writing (htslib-free).

Copy of kallisto_tpu/io/bam.py.  The reader half serves `bus --bam`
(reference: BamSequenceReader, src/ProcessReads.h:114-172); the writer
half produces spec-conformant BAM for --pseudobam and --genomebam: BGZF
blocks (gzip members with the BC extra field) around the binary BAM
payload, and the BAI index of a sorted BAM.  Byte parity with the
reference is checked on the decompressed payload (BGZF block boundaries
are a compressor choice, not content).  zlib is its only dependency.

reference containers: htslib sam_write1/bgzf_write as driven by
src/PseudoBam.cpp and src/ProcessReads.cpp:1962-2363.
"""

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

BAM_CMATCH = 0
BAM_CSOFT_CLIP = 4

FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100

# base code (A=0,C=1,G=2,T=3,N=4) -> nt16 nibble
_NT16 = np.array([1, 2, 4, 8, 15], np.uint8)

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    """Buffers payload bytes and emits <=64 KiB BGZF blocks."""

    MAX = 0xFF00  # htslib block payload size

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX:
            self._emit(bytes(self._buf[: self.MAX]))
            del self._buf[: self.MAX]

    def _emit(self, payload: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25 + 1
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HHH", 6, 0x4342, 2)  # XLEN, 'BC', slen
            + struct.pack("<H", bsize - 1)
            + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload))
        )
        self._f.write(block)

    def close(self) -> None:
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._f.write(_BGZF_EOF)
        self._f.close()


def read_bgzf(path: str) -> bytes:
    """Decompress a BGZF (or plain gzip) file fully."""
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()


def bam_header_bytes(text: str, names: Sequence[str], lens: Sequence[int]) -> bytes:
    out = bytearray(b"BAM\x01")
    t = text.encode()
    out += struct.pack("<i", len(t))
    out += t
    out += struct.pack("<i", len(names))
    for n, l in zip(names, lens):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
    return bytes(out)


def reg2bin(beg: int, end: int) -> int:
    """reference: hts_reg2bin(beg, end, 14, 5) (htslib sam.h)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def pack_seq_nt16(codes: np.ndarray) -> bytes:
    """Base codes -> 4-bit nt16 packed, high nibble first."""
    n = codes.shape[0]
    nib = _NT16[codes]
    if n % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    return (nib[0::2] << 4 | nib[1::2]).tobytes()


def encode_record(
    refid: int,
    pos: int,
    mapq: int,
    bin_: int,
    flag: int,
    mtid: int,
    mpos: int,
    isize: int,
    qname: bytes,
    cigar: List[Tuple[int, int]],   # [(oplen, op)]
    seq_codes: np.ndarray,          # [L] uint8 base codes
    quals: bytes,                   # raw ASCII qualities (phred+33)
    aux: bytes,
) -> bytes:
    nlen = len(qname)
    # no extranul padding: the reference's fillBamRecord writes
    # l_read_name = strlen(name)+1 (ProcessReads.cpp:3021-3100), and BAM
    # byte-parity with its output requires matching that exactly
    extranul = 0
    l_read_name = nlen + extranul + 1
    l_seq = seq_codes.shape[0]
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        refid, pos, l_read_name, mapq, bin_, len(cigar), flag,
        l_seq, mtid, mpos, isize,
    )
    body += qname + b"\x00" * (extranul + 1)
    for oplen, op in cigar:
        body += struct.pack("<I", (oplen << 4) | op)
    body += pack_seq_nt16(seq_codes)
    body += bytes(bytearray((q - 33) & 0xFF for q in quals[:l_seq]))
    body += aux
    return struct.pack("<i", len(body)) + bytes(body)


def aux_i(tag: bytes, val: int) -> bytes:
    return tag + b"i" + struct.pack("<i", val)


def aux_f(tag: bytes, val: float) -> bytes:
    return tag + b"f" + struct.pack("<f", val)


def aux_z(tag: bytes, val: str) -> bytes:
    return tag + b"Z" + val.encode() + b"\x00"


# ---------------------------------------------------------------------------
# BAM reading (htslib-free): header + record parsing over a decompressed
# payload.  Serves BAM input mode (reference: BamSequenceReader,
# src/ProcessReads.h:114-172) and output validation in tests.

_NT16_TO_CODE = np.full(16, 4, np.uint8)
_NT16_TO_CODE[[1, 2, 4, 8]] = [0, 1, 2, 3]

_CIGAR_OPS = "MIDNSHP=X"


class BamRecord:
    __slots__ = (
        "refid", "pos", "mapq", "bin", "flag", "mtid", "mpos", "isize",
        "qname", "cigar", "seq_codes", "quals", "aux",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def aux_get(self, tag: bytes):
        """Linear scan of the aux blob for a two-char tag; returns the
        decoded value or None."""
        a = self.aux
        i = 0
        n = len(a)
        while i + 3 <= n:
            t, typ = a[i : i + 2], a[i + 2 : i + 3]
            if typ == b"Z" or typ == b"H":
                j = a.index(b"\x00", i + 3)
                val = a[i + 3 : j].decode()
                nxt = j + 1
            elif typ in b"cC":
                val = struct.unpack_from("<b" if typ == b"c" else "<B", a, i + 3)[0]
                nxt = i + 4
            elif typ in b"sS":
                val = struct.unpack_from("<h" if typ == b"s" else "<H", a, i + 3)[0]
                nxt = i + 5
            elif typ in b"iI":
                val = struct.unpack_from("<i" if typ == b"i" else "<I", a, i + 3)[0]
                nxt = i + 7
            elif typ == b"f":
                val = struct.unpack_from("<f", a, i + 3)[0]
                nxt = i + 7
            elif typ == b"A":
                val = a[i + 3 : i + 4].decode()
                nxt = i + 4
            elif typ == b"B":
                sub = a[i + 3 : i + 4]
                cnt = struct.unpack_from("<I", a, i + 4)[0]
                sz = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
                val = a[i + 8 : i + 8 + cnt * sz]
                nxt = i + 8 + cnt * sz
            else:
                return None
            if t == tag:
                return val
            i = nxt
        return None


def parse_bam_payload(payload: bytes):
    """Parse a decompressed BAM payload -> (header_text, ref_names,
    ref_lens, records iterator materialized as a list)."""
    if payload[:4] != b"BAM\x01":
        raise ValueError("not a BAM payload")
    (l_text,) = struct.unpack_from("<i", payload, 4)
    text = payload[8 : 8 + l_text].rstrip(b"\x00").decode()
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    names, lens = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 4
        names.append(payload[off : off + l_name - 1].decode())
        off += l_name
        (ln,) = struct.unpack_from("<i", payload, off)
        off += 4
        lens.append(ln)
    records = []
    n = len(payload)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", payload, off)
        off += 4
        end = off + block_size
        (refid, pos, l_read_name, mapq, bin_, n_cigar, flag, l_seq,
         mtid, mpos, isize) = struct.unpack_from("<iiBBHHHiiii", payload, off)
        p = off + 32
        qname = payload[p : p + l_read_name].split(b"\x00")[0]
        p += l_read_name
        cigar = []
        for _ in range(n_cigar):
            (c,) = struct.unpack_from("<I", payload, p)
            cigar.append((c >> 4, _CIGAR_OPS[c & 0xF]))
            p += 4
        nib = np.frombuffer(payload[p : p + ((l_seq + 1) >> 1)], np.uint8)
        both = np.empty(nib.shape[0] * 2, np.uint8)
        both[0::2] = nib >> 4
        both[1::2] = nib & 0xF
        seq_codes = _NT16_TO_CODE[both[:l_seq]]
        p += (l_seq + 1) >> 1
        quals = bytes(
            bytearray(((q + 33) & 0xFF) for q in payload[p : p + l_seq])
        )
        p += l_seq
        aux = payload[p:end]
        records.append(BamRecord(
            refid=refid, pos=pos, mapq=mapq, bin=bin_, flag=flag, mtid=mtid,
            mpos=mpos, isize=isize, qname=qname, cigar=cigar,
            seq_codes=seq_codes, quals=quals, aux=aux,
        ))
        off = end
    return text, names, lens, records


def read_bam(path: str):
    return parse_bam_payload(read_bgzf(path))


# ---------------------------------------------------------------------------
# Sorted BAM + BAI writing.

class VirtualBgzfWriter:
    """BGZF writer that reports htslib-style virtual offsets
    ((compressed block offset) << 16 | within-block offset) for the start
    of the NEXT write.  Blocks are cut at fixed 0xFF00-byte payloads, so
    the mapping from uncompressed position to virtual offset is exact."""

    MAX = 0xFF00

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._file_off = 0

    def tell_virtual(self) -> int:
        return (self._file_off << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX:
            self._emit(bytes(self._buf[: self.MAX]))
            del self._buf[: self.MAX]

    def _emit(self, payload: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25 + 1
        block = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<HHH", 6, 0x4342, 2)
            + struct.pack("<H", bsize - 1)
            + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload))
        )
        self._f.write(block)
        self._file_off += len(block)

    def close(self) -> int:
        """Flush and return the virtual offset of EOF (end of last data)."""
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        eof_v = self._file_off << 16
        self._f.write(_BGZF_EOF)
        self._f.close()
        return eof_v


def write_bai(
    path: str,
    n_ref: int,
    per_record,   # iterable of (refid, pos, end_pos, vbeg, vend, unmapped)
):
    """BAI index writer (SAM spec section 5.2, matching htslib's layout
    incl. the 37450 metadata pseudo-bin and the trailing n_no_coor count;
    reference builds it via sam_index_build3, src/ProcessReads.cpp:818)."""
    bins = [dict() for _ in range(n_ref)]    # bin -> [chunks]
    ioff = [dict() for _ in range(n_ref)]    # 16kb window -> min voffset
    meta = [
        {"beg": None, "end": None, "mapped": 0, "unmapped": 0}
        for _ in range(n_ref)
    ]
    n_no_coor = 0
    for refid, pos, end_pos, vbeg, vend, unmapped in per_record:
        if refid < 0 or pos < 0:
            n_no_coor += 1
            continue
        b = reg2bin(pos, end_pos)
        ch = bins[refid].setdefault(b, [])
        if ch and ch[-1][1] == vbeg:
            ch[-1] = (ch[-1][0], vend)
        else:
            ch.append((vbeg, vend))
        m = meta[refid]
        m["beg"] = vbeg if m["beg"] is None else min(m["beg"], vbeg)
        m["end"] = vend if m["end"] is None else max(m["end"], vend)
        if unmapped:
            m["unmapped"] += 1
        else:
            m["mapped"] += 1
        for w in range(pos >> 14, ((max(end_pos, pos + 1) - 1) >> 14) + 1):
            cur = ioff[refid].get(w)
            if cur is None or vbeg < cur:
                ioff[refid][w] = vbeg
    with open(path, "wb") as f:
        f.write(b"BAI\x01")
        f.write(struct.pack("<i", n_ref))
        for r in range(n_ref):
            bd = bins[r]
            n_bin = len(bd) + (1 if meta[r]["beg"] is not None else 0)
            f.write(struct.pack("<i", n_bin))
            for b in sorted(bd):
                chunks = bd[b]
                f.write(struct.pack("<Ii", b, len(chunks)))
                for cb, ce in chunks:
                    f.write(struct.pack("<QQ", cb, ce))
            if meta[r]["beg"] is not None:
                # metadata pseudo-bin (htslib convention)
                f.write(struct.pack("<Ii", 37450, 2))
                f.write(struct.pack("<QQ", meta[r]["beg"], meta[r]["end"]))
                f.write(struct.pack("<QQ", meta[r]["mapped"], meta[r]["unmapped"]))
            wins = ioff[r]
            n_intv = (max(wins) + 1) if wins else 0
            f.write(struct.pack("<i", n_intv))
            filled = 0
            for w in range(n_intv):
                if w in wins:
                    filled = wins[w]
                f.write(struct.pack("<Q", filled))
        f.write(struct.pack("<Q", n_no_coor))
