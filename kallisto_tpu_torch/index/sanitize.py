"""Transcript FASTA sanitization with exact reference parity.

Rules (reference: src/KmerIndex.cpp:247-411):
- uppercase everything
- U -> T
- any other non-ACGT character -> pseudorandom base from std::mt19937 gen(42),
  base = "ACGT"[gen() & 3] (reference: src/KmerIndex.cpp:163-166,331)
- if the last 10 characters are all 'A', clip the entire poly-A tail
- target length recorded is the ORIGINAL sequence length (pre-clip)
- target name is the FASTA header up to the first space; duplicate names are
  an error unless make_unique, which appends _1, _2, ...
"""

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from ..io.fastx import read_fasta, BASE_CODE
from ..utils.mt19937 import MT19937


class DuplicateNameError(ValueError):
    pass


@dataclass
class SanitizedTranscripts:
    names: List[str] = field(default_factory=list)
    seqs: List[str] = field(default_factory=list)          # post-sanitization
    lens: List[int] = field(default_factory=list)          # pre-clip lengths
    n_non_nucl: int = 0
    n_u: int = 0
    n_polya_clipped: int = 0


def sanitize_transcripts(
    fasta_paths: Sequence[str], make_unique: bool = False, aa: bool = False
) -> SanitizedTranscripts:
    """With aa=True the FASTA holds amino-acid sequences: each is reverse-
    translated to comma-free code (unknown AAs -> NNN) with NO nucleotide
    sanitization (reference: the aa branch of BuildTranscripts,
    src/KmerIndex.cpp:276-315, records length = 3x the AA length)."""
    out = SanitizedTranscripts()
    gen = MT19937(42)
    unique = set()
    dna = "ACGT"

    for path in fasta_paths:
        for header, seq in read_fasta(path):
            if aa:
                from ..utils.cfc import aa_to_cfc

                s = aa_to_cfc(seq)
                name = header.split(" ", 1)[0]
                if name in unique:
                    if not make_unique:
                        raise DuplicateNameError(
                            f"repeated name in FASTA file {path}: {name} "
                            "(run with --make-unique)"
                        )
                    i = 1
                    while f"{name}_{i}" in unique:
                        i += 1
                    name = f"{name}_{i}"
                unique.add(name)
                out.names.append(name)
                out.seqs.append(s)
                out.lens.append(len(s))
                continue
            s = seq.upper()
            # U->T and random fill must be applied in sequence order because
            # the MT19937 stream is shared across all replacements
            codes = BASE_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
            bad = np.flatnonzero(codes == 4)
            if bad.size:
                chars = list(s)
                for i in bad:
                    if chars[i] == "U":
                        chars[i] = "T"
                        out.n_u += 1
                    else:
                        chars[i] = dna[gen() & 3]
                        out.n_non_nucl += 1
                s = "".join(chars)

            orig_len = len(seq)
            if len(s) >= 10 and s.endswith("A" * 10):
                out.n_polya_clipped += 1
                s = s.rstrip("A")

            name = header.split(" ", 1)[0]
            if name in unique:
                if not make_unique:
                    raise DuplicateNameError(
                        f"repeated name in FASTA file {path}: {name} "
                        "(run with --make-unique)"
                    )
                i = 1
                while f"{name}_{i}" in unique:
                    i += 1
                name = f"{name}_{i}"
            unique.add(name)

            out.names.append(name)
            out.seqs.append(s)
            out.lens.append(orig_len)

    return out
