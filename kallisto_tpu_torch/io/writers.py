"""Plaintext output writers with reference-identical formatting.

reference: src/PlaintextWriter.cpp (abundance.tsv, run_info.json, matrix.ec,
counts.txt).  Doubles are formatted exactly like C++ `ostream <<` defaults
(6 significant digits, %g-style), so outputs are byte-comparable with the
reference on identical values.
"""

import os
from typing import Iterable, Sequence

import numpy as np


def cpp_double(x: float) -> str:
    """Format like C++ default ostream << double (precision 6, defaultfloat).

    glibc prints NaNs with the sign bit set as "-nan"; 0.0/0.0 on x86
    produces exactly that, and the reference emits it (e.g. the FLD sd of a
    cell with an empty fragment histogram)."""
    if np.isnan(x):
        return "-nan"
    return f"{x:.6g}"


def write_abundance_tsv(
    path: str,
    target_names: Sequence[str],
    lengths: np.ndarray,
    eff_lens: np.ndarray,
    est_counts: np.ndarray,
    tpm: np.ndarray,
) -> None:
    """reference: plaintext_writer (src/PlaintextWriter.cpp:29-65)."""
    with open(path, "w") as f:
        f.write("target_id\tlength\teff_length\test_counts\ttpm\n")
        for i, name in enumerate(target_names):
            f.write(
                f"{name}\t{int(lengths[i])}\t{cpp_double(float(eff_lens[i]))}\t"
                f"{cpp_double(float(est_counts[i]))}\t{cpp_double(float(tpm[i]))}\n"
            )


def _json_line(key: str, val: str, quote: bool, comma: bool = True) -> str:
    q = '"' if quote else ""
    return f'\t"{key}": {q}{val}{q}' + ("," if comma else "")


def write_run_info(
    path: str,
    n_targets: int,
    n_bootstraps: int,
    n_processed: int,
    n_pseudoaligned: int,
    n_unique: int,
    kallisto_version: str,
    index_version: int,
    k: int,
    start_time: str,
    call: str,
) -> None:
    """reference: plaintext_aux (src/PlaintextWriter.cpp:140-199)."""
    p_uniq = 100.0 * n_unique / n_processed if n_processed > 0 else 0.0
    p_aln = 100.0 * n_pseudoaligned / n_processed if n_processed > 0 else 0.0
    lines = [
        "{",
        _json_line("n_targets", str(n_targets), False),
        _json_line("n_bootstraps", str(n_bootstraps), False),
        _json_line("n_processed", str(n_processed), False),
        _json_line("n_pseudoaligned", str(n_pseudoaligned), False),
        _json_line("n_unique", str(n_unique), False),
        _json_line("p_pseudoaligned", f"{p_aln:.1f}", False),
        _json_line("p_unique", f"{p_uniq:.1f}", False),
        _json_line("kallisto_version", kallisto_version, True),
        _json_line("index_version", str(index_version), False),
        _json_line("k-mer length", str(k), False),
        _json_line("start_time", start_time, True),
        _json_line("call", call, True, comma=False),
        "}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ec_list(path: str, ec_sets: Iterable[np.ndarray]) -> None:
    """matrix.ec: `ec_id<TAB>comma,separated,transcripts`
    (reference: writeECList, src/PlaintextWriter.cpp:235-266)."""
    with open(path, "w") as f:
        for ec, s in enumerate(ec_sets):
            f.write(f"{ec}\t{','.join(str(int(t)) for t in s)}\n")


def write_transcripts(path: str, names: Sequence[str]) -> None:
    """transcripts.txt of `bus`: one target name per line."""
    with open(path, "w") as f:
        for n in names:
            f.write(f"{n}\n")


def write_counts(path: str, counts: np.ndarray) -> None:
    """counts.txt written by --write-index (reference: MinCollector::write
    via ProcessReads.cpp:243-249): `ec_id<TAB>count` per line."""
    with open(path, "w") as f:
        for ec, c in enumerate(counts):
            f.write(f"{ec}\t{int(c)}\n")


def write_bootstrap_tsv(
    out_dir: str,
    b: int,
    target_names: Sequence[str],
    lengths: np.ndarray,
    eff_lens: np.ndarray,
    alpha: np.ndarray,
    tpm: np.ndarray,
) -> None:
    """bs_abundance_{b}.tsv of one bootstrap replicate (--plaintext)."""
    write_abundance_tsv(
        os.path.join(out_dir, f"bs_abundance_{b}.tsv"),
        target_names, lengths, eff_lens, alpha, tpm,
    )
