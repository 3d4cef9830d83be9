"""BAM input (htslib-free): BGZF decompression, header and record parsing.

The reader half of kallisto_tpu/io/bam.py, for `bus --bam` (reference:
BamSequenceReader, src/ProcessReads.h:114-172).  zlib (through gzip) is
its only dependency.
"""

import struct

import numpy as np

FSECONDARY = 0x100


def read_bgzf(path: str) -> bytes:
    """Decompress a BGZF (or plain gzip) file fully."""
    import gzip

    with gzip.open(path, "rb") as f:
        return f.read()


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
