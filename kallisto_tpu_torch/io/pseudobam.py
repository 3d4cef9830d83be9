"""--pseudobam: BAM output of pseudoalignments in transcriptome coordinates.

Faithful port of the reference replay path (AlnProcessor::processBufferTrans,
src/ProcessReads.cpp:1962-2363; fillBamRecord/fixCigarStringTrans/
reverseComplementSeqInData, 2908-3070; createPseudoBamHeaderTrans,
src/PseudoBam.cpp:7-23).  During read processing the pipeline records one
PseudoAlignmentInfo equivalent per fragment; after the EM, records are
replayed into a BGZF BAM with per-target EM posterior ZW tags.

Parity is asserted on the decompressed BAM payload (BGZF framing is a
compressor choice).

A copy of kallisto_tpu/io/pseudobam.py (numpy and the standard library).
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bam import (
    BgzfWriter,
    FMREVERSE,
    FMUNMAP,
    FPAIRED,
    FPROPER_PAIR,
    FREAD1,
    FREAD2,
    FREVERSE,
    FSECONDARY,
    FUNMAP,
    BAM_CMATCH,
    BAM_CSOFT_CLIP,
    aux_f,
    aux_i,
    bam_header_bytes,
    encode_record,
    reg2bin,
)

_EM_TOLERANCE = 5e-324  # std::numeric_limits<double>::denorm_min()


@dataclass
class _Batch:
    names: List[bytes]
    seq1: List[np.ndarray]      # base codes per read
    qual1: List[bytes]
    f1: dict                    # has_hits, f_block, f_upos, f_rpos, f_strand
    read_ec: np.ndarray
    seq2: Optional[List[np.ndarray]] = None
    qual2: Optional[List[bytes]] = None
    f2: Optional[dict] = None


class PseudoAlnRecorder:
    """pseudoaln.bin-style disk spill of per-read pseudoalignment info.

    The reference streams PseudoAlignmentInfo batches to
    output/pseudoaln.bin during read processing and replays them after the
    EM, re-fetching the read sequences from the input FASTQs
    (reference: src/PseudoBam.h:26-50, MasterProcessor::processAln,
    src/ProcessReads.cpp:649-825).  Same design here: the first pass spills
    only [read_ec + per-mate (has_hits, first-kmer payload)] -- 18/32
    bytes/read -- and the BAM writers re-read the FASTQs on replay, so
    peak RSS stays flat in the run length.
    """

    def __init__(self, paired: bool, spill_path: str):
        self.paired = paired
        self.path = spill_path
        self._f = open(spill_path, "wb")
        self._ns: List[int] = []   # reads per spilled batch

    def _side_arrays(self, f: dict):
        return [
            f["has_hits"].astype(np.uint8),
            f["f_block"].astype(np.int32),
            f["f_upos"].astype(np.int32),
            f["f_rpos"].astype(np.int32),
            f["f_strand"].astype(np.uint8),
        ]

    def add_compact(self, read_ec: np.ndarray, f1: dict,
                    f2: Optional[dict] = None) -> None:
        n = int(read_ec.shape[0])
        self._ns.append(n)
        arrs = [read_ec.astype(np.int32)] + self._side_arrays(f1)
        if self.paired:
            arrs += self._side_arrays(f2)
        for a in arrs:
            self._f.write(np.ascontiguousarray(a).tobytes())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def _read_side(self, f, n: int) -> dict:
        return {
            "has_hits": np.frombuffer(f.read(n), np.uint8).astype(bool),
            "f_block": np.frombuffer(f.read(4 * n), np.int32),
            "f_upos": np.frombuffer(f.read(4 * n), np.int32),
            "f_rpos": np.frombuffer(f.read(4 * n), np.int32),
            "f_strand": np.frombuffer(f.read(n), np.uint8).astype(bool),
        }

    def iter_batches(self, read_stream):
        """Replay: zip the spilled records with a second pass over the
        input reads (read_stream yields per-read tuples
        (name, codes1, qual1[, codes2, qual2])), yielding _Batch objects.
        """
        self.close()
        with open(self.path, "rb") as f:
            for n in self._ns:
                read_ec = np.frombuffer(f.read(4 * n), np.int32)
                f1 = self._read_side(f, n)
                f2 = self._read_side(f, n) if self.paired else None
                names, s1, q1 = [], [], []
                s2: Optional[list] = [] if self.paired else None
                q2: Optional[list] = [] if self.paired else None
                for _ in range(n):
                    r = next(read_stream)
                    names.append(r[0])
                    s1.append(r[1])
                    q1.append(r[2])
                    if self.paired:
                        s2.append(r[3])
                        q2.append(r[4])
                yield _Batch(
                    names=names, seq1=s1, qual1=q1, f1=f1, read_ec=read_ec,
                    seq2=s2, qual2=q2, f2=f2,
                )


def _revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes)[::-1].copy()


def _strandedness_info(index, block: int, ua_tx: set):
    """Port of the strandednessInfo lambda (ProcessReads.cpp:2141-2177).

    Returns (consistent, trsense == um.strand input is applied by caller).
    """
    if block < 0:
        return False, False
    row = int(index.block_ec[block])
    if row < 0:
        return False, False
    bs, be = int(index.bp_ptr[block]), int(index.bp_ptr[block + 1])
    txs = index.bp_tx[bs:be]
    if txs.shape[0] == 0:
        return False, False
    strands = index.bp_strand[bs:be]
    trsense = bool(strands[0] != 0)  # bp_tx is tx-sorted: [0] = minimum
    for t, c in zip(txs, strands):
        # "(!v_ec[trs[i]]) != trsense" transcribed literally
        if ((c == 0) != trsense) and int(t) in ua_tx:
            return False, False
    return True, trsense


def _find_position(index, pl, block: int, tx: int, upos: int, rpos: int,
                   strand: bool):
    """KmerIndex::findPosition -> (x, sense) for one (read, target)."""
    pidx, found = pl.find(np.array([block]), np.array([tx]))
    if not bool(found[0]):
        return -1, True
    p = int(pidx[0])
    raw = int(pl.bp_pos[p])
    trsense = (raw >> 31) == 0
    t0 = raw & 0x7FFFFFFF
    rstart = int(pl.bp_rstart[p])
    rstop = int(pl.bp_rstop[p])
    t_kmer = t0 + (upos - rstart) if trsense else t0 + (rstop - 1 - upos)
    sense = trsense == strand
    x = t_kmer - rpos + 1 if sense else t_kmer + pl.k + rpos
    return x, sense


def _cigar_trans(rlen: int, softclip: int, overhang: int):
    """fixCigarStringTrans (ProcessReads.cpp:2943-2985)."""
    if softclip <= 0 and overhang <= 0:
        return [(rlen, BAM_CMATCH)]
    if softclip > 0 and overhang > 0:
        return [
            (softclip, BAM_CSOFT_CLIP),
            (rlen - overhang - softclip, BAM_CMATCH),
            (overhang, BAM_CSOFT_CLIP),
        ]
    if softclip > 0:
        return [(softclip, BAM_CSOFT_CLIP), (rlen - softclip, BAM_CMATCH)]
    return [(rlen - overhang, BAM_CMATCH), (overhang, BAM_CSOFT_CLIP)]


_CIG_OP = {"M": BAM_CMATCH, "N": 3, "S": BAM_CSOFT_CLIP}


def write_pseudobam_genome(
    path: str,
    index,
    recorder: PseudoAlnRecorder,
    ec_sets: List[np.ndarray],
    alpha: np.ndarray,
    eff_lens: np.ndarray,
    counts: np.ndarray,
    model,
    version: str,
    read_stream=None,
    use_em: bool = True,
) -> None:
    """--genomebam: project pseudoalignments onto the genome and write a
    position-sorted BAM + BAI (reference: AlnProcessor::processBufferGenome,
    src/ProcessReads.cpp:2363-2908; sort/merge in MasterProcessor::processAln,
    649-825; header: createPseudoBamHeaderGenome, src/PseudoBam.cpp:31-56).

    Documented divergences: the reference accumulates per-read alignment
    groups in an unordered_map and sorts with an unstable comparator, so
    tie order among equal-position records and the 'arbitrary' best-
    alignment pick for multimapping EM reads are unspecified there; here
    both follow first-seen order deterministically.
    """
    from ..quant.filters import _PayloadLookup
    from .bam import VirtualBgzfWriter, write_bai

    pl = _PayloadLookup(index)
    paired = recorder.paired

    mapped: List[tuple] = []   # (sortkey, order, record bytes, refid, pos, endpos, unmapped_flag)
    unmapped_tail: List[bytes] = []
    order = 0

    def rec(refid, pos, mapq, bin_, flag, mtid, mpos, isize, name, cig,
            codes, quals, aux):
        return encode_record(
            refid, pos, mapq, bin_, flag, mtid, mpos, isize, name, cig,
            codes, quals, aux,
        )

    def add(b, refid, pos, flag, cig):
        nonlocal order
        if refid == -1:
            unmapped_tail.append(b)
            return
        key = (np.uint64(refid) << np.uint64(32)) | (
            np.uint64(pos + 1) << np.uint64(1)
        ) | np.uint64((flag & FREVERSE) >> 4)
        ref_len = sum(ln for ln, op in cig if op in (BAM_CMATCH, 3))
        endpos = pos + ref_len if ref_len > 0 else pos + 1
        mapped.append((int(key), order, b, refid, pos, endpos,
                       bool(flag & FUNMAP)))
        order += 1

    for batch in recorder.iter_batches(read_stream):
        n = len(batch.names)
        for i in range(n):
            name = batch.names[i]
            s1, q1 = batch.seq1[i], batch.qual1[i]
            s2 = batch.seq2[i] if paired else None
            q2 = batch.qual2[i] if paired else None
            r1empty = not bool(batch.f1["has_hits"][i])
            r2empty = not (paired and bool(batch.f2["has_hits"][i]))
            ec = int(batch.read_ec[i])
            rlen1 = s1.shape[0]
            rlen2 = s2.shape[0] if paired else 0

            flag1 = FUNMAP
            flag2 = 0
            if paired:
                flag1 = FPAIRED | FREAD1 | FUNMAP | FMUNMAP
                flag2 = FPAIRED | FREAD2 | FUNMAP | FMUNMAP

            def emit_unmapped():
                unmapped_tail.append(rec(
                    -1, -1, 0, 4680, flag1, -1, -1, 0, name, [], s1, q1, b""
                ))
                if paired:
                    unmapped_tail.append(rec(
                        -1, -1, 0, 4680, flag2, -1, -1, 0, name, [], s2, q2,
                        b"",
                    ))

            if (r1empty and r2empty) or ec < 0:
                emit_unmapped()
                continue

            trs = ec_sets[ec]
            ua = []
            if use_em:
                inv = 1.0 / eff_lens[trs]
                denom = float(counts[ec]) * float(np.sum(alpha[trs] * inv))
                if denom >= _EM_TOLERANCE:
                    for t, iv in zip(trs, inv):
                        a = float(alpha[t])
                        if a > 0.0:
                            ua.append(
                                (int(t), a * float(counts[ec]) * iv / denom)
                            )
            else:
                ua = [(int(t), 0.0) for t in trs]
            if not ua:
                emit_unmapped()
                continue
            ua_tx = {t for t, _ in ua}

            if not r1empty:
                flag1 &= ~FUNMAP
                if paired:
                    flag2 &= ~FMUNMAP
            if paired and not r2empty:
                flag1 &= ~FMUNMAP
                flag2 &= ~FUNMAP
            if paired and not r1empty and not r2empty:
                flag1 |= FPROPER_PAIR
                flag2 |= FPROPER_PAIR

            str1 = (True, True)
            str2 = (True, True)
            if not r1empty:
                str1 = _strandedness_info(index, int(batch.f1["f_block"][i]), ua_tx)
            if paired and not r2empty:
                str2 = _strandedness_info(index, int(batch.f2["f_block"][i]), ua_tx)
            base_rc1 = (not r1empty) and str1[0] and not (
                str1[1] == bool(batch.f1["f_strand"][i])
            )
            base_rc2 = paired and (not r2empty) and str2[0] and not (
                str2[1] == bool(batch.f2["f_strand"][i])
            )

            # group alignments: (tra1, tra2) -> summed probability
            # (reference: alnmap, ProcessReads.cpp:2688-2718)
            alnmap = {}
            none_key = (-1, -1, True, ())
            for t, prob in ua:
                k1 = none_key
                k2 = none_key
                if not r1empty:
                    x1, sense1 = _find_position(
                        index, pl, int(batch.f1["f_block"][i]), t,
                        int(batch.f1["f_upos"][i]), int(batch.f1["f_rpos"][i]),
                        bool(batch.f1["f_strand"][i]),
                    )
                    trpos = x1 - 1 if sense1 else x1 - rlen1
                    tra1 = model.translate_tr_position(t, trpos, rlen1, sense1)
                    if tra1 is None:
                        continue
                    k1 = (tra1.chr, tra1.chrpos, tra1.strand, tuple(tra1.cigar))
                if paired and not r2empty:
                    x2, sense2 = _find_position(
                        index, pl, int(batch.f2["f_block"][i]), t,
                        int(batch.f2["f_upos"][i]), int(batch.f2["f_rpos"][i]),
                        bool(batch.f2["f_strand"][i]),
                    )
                    trpos = x2 - 1 if sense2 else x2 - rlen2
                    tra2 = model.translate_tr_position(t, trpos, rlen2, sense2)
                    if tra2 is None:
                        continue
                    k2 = (tra2.chr, tra2.chrpos, tra2.strand, tuple(tra2.cigar))
                alnmap[(k1, k2)] = alnmap.get((k1, k2), 0.0) + prob

            if not alnmap:
                emit_unmapped()
                continue

            if len(alnmap) == 1:
                best_key = next(iter(alnmap))
                bestprob = 1.0
            else:
                bestprob = max(alnmap.values())
                if use_em:
                    best_key = next(iter(alnmap))  # reference: arbitrary pick
                else:
                    best_key = max(alnmap, key=alnmap.get)

            for key, prob in alnmap.items():
                (c1, cp1, st1, cig1t), (c2, cp2, st2, cig2t) = key
                best = (bestprob == 1.0) or (key == best_key)

                f1, f2 = flag1, flag2
                rc1 = base_rc1 or ((not str1[0]) and not st1 and not r1empty)
                rc2 = paired and (
                    base_rc2 or ((not str2[0]) and not st2 and not r2empty)
                )
                if paired:
                    if not r1empty and not st1:
                        f1 |= FREVERSE
                        f2 |= FMREVERSE
                    if not r2empty and not st2:
                        f1 |= FMREVERSE
                        f2 |= FREVERSE
                elif not r1empty and not st1:
                    f1 |= FREVERSE
                if not best:
                    f1 |= FSECONDARY
                    f2 |= FSECONDARY

                cig1 = (
                    [(ln, _CIG_OP[op]) for ln, op in cig1t]
                    if cig1t else ([] if r1empty else [(rlen1, BAM_CMATCH)])
                )
                cig2 = (
                    [(ln, _CIG_OP[op]) for ln, op in cig2t]
                    if cig2t else (
                        [] if (not paired or r2empty) else [(rlen2, BAM_CMATCH)]
                    )
                )
                # single-exon alignments keep the default rlen-M cigar
                # (fixCigarStringGenome early-returns on ncig == 1)
                if not r1empty and len(cig1t) == 1:
                    cig1 = [(rlen1, BAM_CMATCH)]
                if paired and not r2empty and len(cig2t) == 1:
                    cig2 = [(rlen2, BAM_CMATCH)]

                tid1, p1 = c1, cp1
                bin1 = 4680
                q1m = 0
                if not r1empty:
                    bin1 = reg2bin(p1, p1 + rlen1 - 1)
                    q1m = 255
                tid2, p2 = c2, cp2
                bin2 = 4680
                q2m = 0
                if paired:
                    if not r2empty:
                        # reference quirk: b2's bin end = pos + slen
                        bin2 = reg2bin(p2, p2 + rlen2)
                        q2m = 255
                        if r1empty:
                            tid1, p1, bin1, q1m = tid2, p2, bin2, 0
                    else:
                        tid2, p2, q2m = tid1, p1, 0

                isize1 = isize2 = 0
                if paired and not r1empty and not r2empty:
                    tlen = (p2 + rlen2) - p1
                    isize1, isize2 = tlen, -tlen

                aux = aux_f(b"ZW", prob) if use_em else b""

                if (not r1empty) or best:
                    add(
                        rec(
                            tid1, p1, q1m, bin1, f1,
                            tid2 if paired else -1, p2 if paired else -1,
                            isize1, name, cig1,
                            _revcomp_codes(s1) if rc1 else s1,
                            q1[::-1] if rc1 else q1, aux,
                        ),
                        tid1, p1, f1, cig1,
                    )
                if paired and ((not r2empty) or best):
                    add(
                        rec(
                            tid2, p2, q2m, bin2, f2, tid1, p1, isize2,
                            name, cig2,
                            _revcomp_codes(s2) if rc2 else s2,
                            q2[::-1] if rc2 else q2, aux,
                        ),
                        tid2, p2, f2, cig2,
                    )

    mapped.sort(key=lambda x: (x[0], x[1]))

    w = VirtualBgzfWriter(path)
    text = f"@HD\tVN:1.0\n@PG\tID:kallisto\tPN:kallisto\tVN:{version}\n"
    for nm, ln in zip(model.chr_names, model.chr_lens):
        text += f"@SQ\tSN:{nm}\tLN:{ln}\n"
    w.write(bam_header_bytes(text, model.chr_names, model.chr_lens))
    per_record = []
    for _, _, b, refid, pos, endpos, is_unmapped in mapped:
        vbeg = w.tell_virtual()
        w.write(b)
        per_record.append((refid, pos, endpos, vbeg, w.tell_virtual(), is_unmapped))
    for b in unmapped_tail:
        vbeg = w.tell_virtual()
        w.write(b)
        per_record.append((-1, -1, 0, vbeg, w.tell_virtual(), True))
    w.close()
    write_bai(path + ".bai", len(model.chr_names), per_record)


def write_pseudobam_trans(
    path: str,
    index,
    recorder: PseudoAlnRecorder,
    ec_sets: List[np.ndarray],
    alpha: np.ndarray,
    eff_lens: np.ndarray,
    counts: np.ndarray,
    version: str,
    read_stream=None,
    use_em: bool = True,
) -> None:
    from ..quant.filters import _PayloadLookup

    pl = _PayloadLookup(index)
    paired = recorder.paired
    nl = index.num_onlist

    w = BgzfWriter(path)
    text = f"@HD\tVN:1.0\n@PG\tID:kallisto\tPN:kallisto\tVN:{version}\n"
    w.write(bam_header_bytes(
        text, index.target_names[:nl], index.target_lens[:nl]
    ))

    def emit_unmapped(name, s1, q1, s2, q2):
        f1 = FUNMAP
        if paired:
            f1 = FPAIRED | FREAD1 | FUNMAP | FMUNMAP
        w.write(encode_record(
            -1, -1, 0, 4680, f1, -1, -1, 0, name, [], s1, q1, b""
        ))
        if paired:
            f2 = FPAIRED | FREAD2 | FUNMAP | FMUNMAP
            w.write(encode_record(
                -1, -1, 0, 4680, f2, -1, -1, 0, name, [], s2, q2, b""
            ))

    for b in recorder.iter_batches(read_stream):
        n = len(b.names)
        for i in range(n):
            name = b.names[i]
            s1, q1 = b.seq1[i], b.qual1[i]
            s2 = b.seq2[i] if paired else None
            q2 = b.qual2[i] if paired else None
            r1empty = not bool(b.f1["has_hits"][i])
            r2empty = not (paired and bool(b.f2["has_hits"][i]))
            ec = int(b.read_ec[i])
            rlen1 = s1.shape[0]
            rlen2 = s2.shape[0] if paired else 0

            if (r1empty and r2empty) or ec < 0:
                emit_unmapped(name, s1, q1, s2, q2)
                continue

            trs = ec_sets[ec]
            ua = []
            best_tr = -1
            if use_em:
                inv = 1.0 / eff_lens[trs]
                denom = float(counts[ec]) * float(np.sum(alpha[trs] * inv))
                if denom < _EM_TOLERANCE:
                    ua = []
                else:
                    best_p = 0.0
                    for t, iv in zip(trs, inv):
                        a = float(alpha[t])
                        if a > 0.0:
                            prob = a * float(counts[ec]) * iv / denom
                            ua.append((int(t), prob))
                            if prob > best_p:
                                best_p = prob
                                best_tr = int(t)
            else:
                ua = [(int(t), 0.0) for t in trs]
                best_tr = int(trs[0])
            if not ua:
                emit_unmapped(name, s1, q1, s2, q2)
                continue

            ua_tx = {t for t, _ in ua}
            nmap = len(ua)

            flag1 = FUNMAP
            flag2 = 0
            if paired:
                flag1 = FPAIRED | FREAD1 | FUNMAP | FMUNMAP
                flag2 = FPAIRED | FREAD2 | FUNMAP | FMUNMAP
            if not r1empty:
                flag1 &= ~FUNMAP
                if paired:
                    flag2 &= ~FMUNMAP
            if paired and not r2empty:
                flag1 &= ~FMUNMAP
                flag2 &= ~FUNMAP
            if paired and not r1empty and not r2empty:
                flag1 |= FPROPER_PAIR
                flag2 |= FPROPER_PAIR

            str1 = (True, True)
            str2 = (True, True)
            if not r1empty:
                str1 = _strandedness_info(
                    index, int(b.f1["f_block"][i]), ua_tx
                )
            if paired and not r2empty:
                str2 = _strandedness_info(
                    index, int(b.f2["f_block"][i]), ua_tx
                )
            base_rc1 = str1[0] and not (
                str1[1] == bool(b.f1["f_strand"][i]) if not r1empty else True
            )
            base_rc2 = paired and str2[0] and not (
                str2[1] == bool(b.f2["f_strand"][i]) if not r2empty else True
            )

            for t, prob in ua:
                best = t == best_tr
                if not r1empty:
                    pos1 = _find_position(
                        index, pl, int(b.f1["f_block"][i]), t,
                        int(b.f1["f_upos"][i]), int(b.f1["f_rpos"][i]),
                        bool(b.f1["f_strand"][i]),
                    )
                else:
                    pos1 = (-(2**31), True)
                if paired:
                    if not r2empty:
                        pos2 = _find_position(
                            index, pl, int(b.f2["f_block"][i]), t,
                            int(b.f2["f_upos"][i]), int(b.f2["f_rpos"][i]),
                            bool(b.f2["f_strand"][i]),
                        )
                    else:
                        pos2 = (-(2**31), True)

                rc1 = base_rc1 or ((not str1[0]) and not pos1[1])
                rc2 = paired and (base_rc2 or ((not str2[0]) and not pos2[1]))

                f1, f2 = flag1, flag2
                if paired:
                    if not r1empty and not pos1[1]:
                        f1 |= FREVERSE
                        f2 |= FMREVERSE
                    if not r2empty and not pos2[1]:
                        f1 |= FMREVERSE
                        f2 |= FREVERSE
                elif not r1empty and not pos1[1]:
                    f1 |= FREVERSE
                if not best:
                    f1 |= FSECONDARY
                    f2 |= FSECONDARY

                tlen = int(index.target_lens[t])
                cig1 = [] if r1empty else [(rlen1, BAM_CMATCH)]
                cig2 = [] if (not paired or r2empty) else [(rlen2, BAM_CMATCH)]
                p1 = p2 = -1
                bin1 = bin2 = 4680
                q1m = q2m = 0
                if not r1empty:
                    p1 = pos1[0] - 1 if pos1[1] else pos1[0] - rlen1
                    sc1, oh1 = -p1, p1 + rlen1 - tlen
                    p1 = max(p1, 0)
                    bin1 = reg2bin(p1, p1 + rlen1 - 1)
                    q1m = 255
                    if sc1 > 0 or oh1 > 0:
                        cig1 = _cigar_trans(rlen1, sc1, oh1)
                if paired:
                    if not r2empty:
                        p2 = pos2[0] - 1 if pos2[1] else pos2[0] - rlen2
                        sc2, oh2 = -p2, p2 + rlen2 - tlen
                        p2 = max(p2, 0)
                        # reference quirk: b2's bin uses end = pos + slen
                        bin2 = reg2bin(p2, p2 + rlen2)
                        q2m = 255
                        if sc2 > 0 or oh2 > 0:
                            cig2 = _cigar_trans(rlen2, sc2, oh2)
                        if r1empty:
                            p1, bin1, q1m = p2, bin2, 0
                    else:
                        p2, bin2, q2m = p1, bin1, 0

                isize1 = isize2 = 0
                if paired and not r1empty and not r2empty:
                    tl = pos2[0] - pos1[0]
                    if tl != 0:
                        tl += 1 if tl > 0 else -1
                    isize1, isize2 = tl, -tl

                aux = aux_i(b"NH", nmap)
                if use_em:
                    aux += aux_f(b"ZW", prob)

                if not r1empty or best:
                    w.write(encode_record(
                        t, p1, q1m, bin1, f1,
                        t if paired else -1, p2 if paired else -1, isize1,
                        name, cig1,
                        _revcomp_codes(s1) if rc1 else s1,
                        q1[::-1] if rc1 else q1,
                        aux,
                    ))
                if paired and (not r2empty or best):
                    w.write(encode_record(
                        t, p2, q2m, bin2, f2, t, p1, isize2,
                        name, cig2,
                        _revcomp_codes(s2) if rc2 else s2,
                        q2[::-1] if rc2 else q2,
                        aux,
                    ))
    w.close()
