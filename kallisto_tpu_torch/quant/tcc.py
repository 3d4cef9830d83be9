"""quant-tcc: per-cell EM over transcript-compatibility-count matrices.

Port of kallisto_tpu/quant/tcc.py (reference: src/main.cpp:2802-3220).  The
reference runs one EM thread per cell; here every cell of a chunk is a
replicate of ONE batched EM (quant/em.py run_em_batch: kernel G on the
card) with a shared EC structure and per-cell counts and effective
lengths (JAX's batched_eff), in float64: the JAX package drops to float32
on its accelerator only because the TPU has no float64, and the H100 has
it, so the card's cells equal the float64 CPU run.

Surface: MatrixMarket or flat (single-cell) TCC files, -i index or -T
txnames (index-free), -e ec file, -l/-s or -f FLD file, -g t2g or -G GTF
gene rollup, -p priors, -b bootstraps, --long (-P ONT skips effective
lengths; other platforms add singleton counts after the EM loop),
--matrix-to-files / --matrix-to-directories per-cell outputs, --plaintext.

Several devices (JAX tcc.py:242-290): with n = max(n_devices, min(-t,
device count), 1) > 1, each chunk of cells is split into n contiguous
cell shards, and each shard runs its own batched EM (kernel G) on its
device -- cuda:((base + s) % device_count), or the CPU -- in a thread of
its own.  A cell's EM does not depend on the other cells of its batch, so
every est_counts equals the one-device run's bitwise.
"""

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..common import MAX_FRAG_LEN, Options, REFERENCE_INDEX_VERSION
from ..io import writers
from ..parallel.mesh import make_mesh, n_shards
from .bootstrap import run_bootstraps
from .em import build_em_problem, counts_to_tpm, read_priors, run_em_batch
from .fld import (
    calc_eff_lens,
    compute_mean_frag_lens_trunc,
    get_frag_len_means,
    trunc_gaussian_counts,
    trunc_gaussian_fld,
)
from .genemodel import Transcriptome, rollup_to_genes


def load_ec_file(path: str, num_trans: int) -> List[np.ndarray]:
    """matrix.ec: `ec<TAB>t1,t2,...` with sequential EC ids
    (reference: KmerIndex::loadECsFromFile, src/KmerIndex.cpp:1561-1599)."""
    ec_sets: List[np.ndarray] = []
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.split()
            if int(parts[0]) != i:
                raise ValueError(
                    f"equivalence class file has a misplaced equivalence class: "
                    f"found {parts[0]}, expected {i}"
                )
            txs = np.array([int(x) for x in parts[1].split(",")], np.int32)
            if (txs < 0).any() or (txs >= num_trans).any():
                raise ValueError(f"equivalence class file has invalid value in {parts[1]}")
            ec_sets.append(txs)
    return ec_sets


def load_tcc_matrix(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, bool]:
    """Parse a MatrixMarket TCC file (rows = cells, cols = ECs) or a flat
    2-column `ec count` file (single cell).

    Returns (rows, cols, vals) 0-based plus (nrow, ncol, is_matrix).
    reference: src/main.cpp:2821-2899.
    """
    with open(path) as f:
        first = f.readline()
        if first.startswith("%%MatrixMarket"):
            line = f.readline()
            while line.startswith("%"):
                line = f.readline()
            nrow, ncol, nlines = (int(x) for x in line.split())
            data = np.loadtxt(f, dtype=np.int64, ndmin=2, max_rows=nlines)
            if data.shape[0] < nlines:
                raise ValueError(
                    f"found only {data.shape[0]} entries in TCC matrix file, "
                    f"expected {nlines}"
                )
            rows, cols, vals = data[:, 0] - 1, data[:, 1] - 1, data[:, 2]
            if (rows >= nrow).any() or (cols >= ncol).any():
                raise ValueError("TCC matrix file is malformed")
            return rows, cols, vals, nrow, ncol, True
        # flat: zero-indexed `ec count`
        entries = [first] + f.readlines()
    data = np.loadtxt(entries, dtype=np.int64, ndmin=2)
    cols, vals = data[:, 0], data[:, 1]
    return np.zeros_like(cols), cols, vals, 1, int(cols.max()) + 1, False


def load_fld_file(path: str, num_trans: int) -> List[np.ndarray]:
    """Per-cell (or shared) FLD histograms, space-separated
    (reference: src/main.cpp:2936-2973)."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            vec = np.array([int(x) for x in line.split(" ") if x.strip() != ""], np.uint32)
            if vec.shape[0] not in (MAX_FRAG_LEN, num_trans):
                raise ValueError(
                    f"fragment length distribution line has {vec.shape[0]} values; "
                    f"expected {MAX_FRAG_LEN}"
                )
            out.append(vec)
    return out


def load_txnames(path: str) -> List[str]:
    """-T txnames: whitespace-separated target names, index-free mode
    (reference: KmerIndex::loadTranscriptsFromFile, src/KmerIndex.cpp:1602-1620)."""
    names: List[str] = []
    with open(path) as f:
        for line in f:
            names.extend(line.split())
    print(
        f"[index] number of targets loaded from file: {len(names):,}",
        file=sys.stderr,
    )
    return names


@dataclass
class TccResult:
    est_counts: np.ndarray     # [C, T]
    tpm: np.ndarray            # [C, T]
    eff_lens: np.ndarray       # [C, T]
    fld_stats: Optional[np.ndarray]  # [C, 2] (mean, sd) or None
    gene_counts: Optional[np.ndarray]
    gene_tpm: Optional[np.ndarray]
    # host seconds (`load_s`, `eff_s`, `em_s`, `write_s`) and the EM's
    # `chunks`, `em_rounds` (the rounds of its chunks, summed) and
    # `em_host_reads` (its loops' reads of their state, summed)
    timings: dict


def _write_gene_tsv(path: str, model: Transcriptome, alpha, eff_lens):
    """reference: plaintext_writer_gene (src/PlaintextWriter.cpp:67-112) --
    every gene is written, including zero-count ones."""
    tpm = counts_to_tpm(alpha, eff_lens)
    ng = len(model.genes)
    gc = rollup_to_genes(alpha, model.tx_gene, ng)
    gc_tpm = np.zeros(ng, np.float64)
    mask = (model.tx_gene >= 0) & (alpha > 0)
    np.add.at(gc_tpm, model.tx_gene[mask], tpm[mask])
    with open(path, "w") as f:
        f.write("gene_id\tgene_name\test_counts\ttpm\n")
        for i, g in enumerate(model.genes):
            f.write(
                f"{g.name}\t{g.common_name}\t"
                f"{writers.cpp_double(gc[i])}\t{writers.cpp_double(gc_tpm[i])}\n"
            )


def run_quant_tcc(opt: Options, index=None, chunk: int = 256,
                  device=None) -> TccResult:
    """quant-tcc of `opt.tcc_file` on `device` (default: the card; raises
    without one unless device='cpu'), `chunk` cells per batched EM."""
    dev = resolve_device(device)
    n_dev = n_shards(opt, dev, tcc=True)
    timings = dict.fromkeys(("load_s", "eff_s", "em_s", "write_s"), 0.0)
    timings.update(chunks=0, em_rounds=0, em_host_reads=0)
    t0 = time.perf_counter()
    if opt.txnames_file:
        # index-free: names from file, zero lengths
        if opt.index_path:
            raise ValueError(
                "cannot supply both a kallisto index file and a transcripts file"
            )
        target_names = load_txnames(opt.txnames_file)
        target_lens = np.zeros(len(target_names), np.uint32)
        # the reference's onlist stays empty in index-free mode, so no
        # transcripts.txt is written (main.cpp:2914-2920)
        num_onlist = 0
    else:
        if index is None:
            from ..index import load_index

            index = load_index(opt.index_path)
        target_names = index.target_names
        target_lens = index.target_lens
        num_onlist = index.num_onlist
    T = len(target_names)

    ec_sets = load_ec_file(opt.ec_file, T)
    rows, cols, vals, C, ncol, is_matrix = load_tcc_matrix(opt.tcc_file)
    if ncol > len(ec_sets):
        raise ValueError("TCC matrix has more ECs than the EC file")

    counts = np.zeros((C, len(ec_sets)), np.float64)
    counts[rows, cols] = vals
    t1 = time.perf_counter()
    timings["load_s"] = t1 - t0

    calc_eff = bool(opt.fld_file) or opt.fld_mean != 0.0
    # the PacBio long-read path ignores a supplied FLD file unless the
    # platform is PACBIO (reference: main.cpp:2944)
    use_fld_file = bool(opt.fld_file) and (
        not opt.long_read or opt.platform.upper() == "PACBIO"
    )
    flds: List[np.ndarray] = []
    if calc_eff and use_fld_file:
        flds = load_fld_file(opt.fld_file, T)
        if len(flds) not in (1, C):
            raise ValueError(
                f"fragment length distribution file contains {len(flds)} lines; "
                f"expected {C}"
            )

    # ONT long reads skip effective-length computation entirely
    # (reference: main.cpp:2999 `!opt.long_read || !(opt.platform == "ONT")`)
    calc_eff_now = calc_eff and (
        not opt.long_read or opt.platform.upper() != "ONT"
    )

    # per-cell effective lengths (reference: EM_lambda, main.cpp:2996-3016)
    eff_lens = np.empty((C, T), np.float64)
    fld_stats = np.zeros((C, 2), np.float64) if calc_eff_now else None
    for c in range(C):
        if calc_eff_now:
            if opt.fld_mean != 0.0:
                # -l/-s: truncated-gaussian conditional means; the cell's
                # observed flens histogram stays EMPTY, so the reported sd is
                # NaN exactly as in the reference (init_mean_fl_trunc +
                # get_sd_frag_len over empty flens, main.cpp:2999,3011-3013)
                mft = trunc_gaussian_fld(0, MAX_FRAG_LEN, opt.fld_mean, opt.fld_sd)
                mean_fl = mft[MAX_FRAG_LEN - 1]
                fl = np.zeros(MAX_FRAG_LEN, np.uint32)
            else:
                fl = flds[0] if len(flds) == 1 else flds[c]
                mft = compute_mean_frag_lens_trunc(fl.astype(np.int64))
                tot = fl.sum()
                i = np.arange(fl.shape[0], dtype=np.float64)
                mean_fl = (
                    float((fl * i).sum() / tot) if tot > 0
                    else np.finfo(np.float64).max
                )
            fl_means = get_frag_len_means(target_lens, mft)
            eff_lens[c] = calc_eff_lens(target_lens, fl_means)
            with np.errstate(invalid="ignore", divide="ignore"):
                tot = float(fl.sum())
                i = np.arange(fl.shape[0], dtype=np.float64)
                sd = np.sqrt((fl * (i - mean_fl) ** 2).sum() / tot)
            fld_stats[c] = (mean_fl, sd)
        else:
            # mean fl = target length -> every effective length is 1
            eff_lens[c] = calc_eff_lens(target_lens, target_lens.astype(np.float64))
    t2 = time.perf_counter()
    timings["eff_s"] = t2 - t1

    problem = build_em_problem(ec_sets, T)
    priors = read_priors(opt.priors, T) if opt.priors else None
    print("[quant] Running EM algorithm...", file=sys.stderr)
    est = np.empty((C, T), np.float64)
    # PacBio-style long-read EM adds singleton counts after the loop
    # (reference: EMAlgorithm.h:111,224-357; ONT uses the standard loop)
    singletons_after = opt.long_read and opt.platform.upper() != "ONT"
    devices = make_mesh(n_dev, dev)

    def em_cells(lo, hi, d):
        return run_em_batch(problem, counts[lo:hi], eff_lens[lo:hi],
                            n_iter=10000, min_rounds=50, priors=priors,
                            device=d, singletons_after=singletons_after)

    with ThreadPoolExecutor(n_dev) as pool:
        for lo in range(0, C, chunk):
            hi = min(lo + chunk, C)
            # contiguous cell shards of the chunk, one per device
            per = -(-(hi - lo) // n_dev)
            bounds = [(a, min(a + per, hi)) for a in range(lo, hi, per)]
            rs = list(pool.map(em_cells, *zip(*bounds), devices))
            for (a, b), r in zip(bounds, rs):
                est[a:b] = r.alpha
            timings["chunks"] += 1
            timings["em_rounds"] += max(r.rounds for r in rs)
            timings["em_host_reads"] += sum(r.host_reads for r in rs)
    t3 = time.perf_counter()
    timings["em_s"] = t3 - t2

    tpm = np.stack([counts_to_tpm(est[c], eff_lens[c]) for c in range(C)])

    model: Optional[Transcriptome] = None
    gene_counts = gene_tpm = None
    if opt.genemap and opt.gtf_file:
        raise ValueError("cannot supply both --genemap and --gtf")
    if opt.genemap or opt.gtf_file:
        model = Transcriptome(target_names, target_lens)
        if opt.genemap:
            model.parse_gene_map(opt.genemap)
        else:
            model.parse_gtf(opt.gtf_file, guess_chromosomes=True)
        ng = len(model.genes)
        tx_gene = model.tx_gene
        gene_counts = np.stack(
            [rollup_to_genes(est[c], tx_gene, ng) for c in range(C)]
        )
        gene_tpm = np.stack(
            [rollup_to_genes(tpm[c], tx_gene, ng) for c in range(C)]
        )

    result = TccResult(
        est_counts=est, tpm=tpm, eff_lens=eff_lens, fld_stats=fld_stats,
        gene_counts=gene_counts, gene_tpm=gene_tpm, timings=timings,
    )

    if opt.output_dir:
        os.makedirs(opt.output_dir, exist_ok=True)
        out = opt.output_dir
        if num_onlist > 0:
            writers.write_transcripts(
                os.path.join(out, "transcripts.txt"), target_names[:num_onlist]
            )
        if is_matrix:
            _write_mtx(os.path.join(out, "matrix.abundance.mtx"), est)
            _write_mtx(os.path.join(out, "matrix.abundance.tpm.mtx"), tpm)
            if calc_eff_now:
                _write_mtx(os.path.join(out, "matrix.efflens.mtx"), eff_lens, dense_mask=est > 0)
            if model is not None:
                _write_mtx(os.path.join(out, "matrix.abundance.gene.mtx"), gene_counts)
                _write_mtx(os.path.join(out, "matrix.abundance.gene.tpm.mtx"), gene_tpm)
                with open(os.path.join(out, "genes.txt"), "w") as f:
                    for g in model.genes:
                        f.write(f"{g.name}\n")
            if opt.matrix_to_files:
                _write_per_cell_outputs(
                    opt, out, target_names, target_lens, est, eff_lens,
                    problem, counts, model, dev,
                )
        else:
            # flat TCC file: single-cell plaintext outputs
            # (reference: main.cpp:3156-3184)
            writers.write_abundance_tsv(
                os.path.join(out, "abundance.tsv"),
                target_names, target_lens, eff_lens[0], est[0], tpm[0],
            )
            if model is not None:
                _write_gene_tsv(
                    os.path.join(out, "abundance.gene.tsv"),
                    model, est[0], eff_lens[0],
                )
            if opt.bootstrap > 0:
                bs = run_bootstraps(
                    problem, counts[0], eff_lens[0], opt.bootstrap, opt.seed,
                    device=dev,
                )
                for b in range(opt.bootstrap):
                    writers.write_abundance_tsv(
                        os.path.join(out, f"bs_abundance_{b}.tsv"),
                        target_names, target_lens, eff_lens[0], bs[b],
                        counts_to_tpm(bs[b], eff_lens[0]),
                    )
        if calc_eff_now:
            with open(os.path.join(out, "matrix.fld.tsv"), "w") as f:
                for c in range(C):
                    f.write(
                        f"{c}\t{writers.cpp_double(fld_stats[c,0])}\t"
                        f"{writers.cpp_double(fld_stats[c,1])}\n"
                    )
            with open(os.path.join(out, "transcript_lengths.txt"), "w") as f:
                for n, L in zip(target_names, target_lens):
                    f.write(f"{n} {int(L)}\n")
        timings["write_s"] = time.perf_counter() - t3

    return result


def _write_per_cell_outputs(
    opt, out, target_names, target_lens, est, eff_lens, problem, counts, model,
    dev,
):
    """--matrix-to-files / --matrix-to-directories: one abundance tsv (+h5,
    + bootstraps) per matrix row (reference: main.cpp:3060-3150)."""
    C = est.shape[0]
    bs_all = None
    if opt.bootstrap > 0:
        bs_all = [
            run_bootstraps(problem, counts[c], eff_lens[c], opt.bootstrap,
                           opt.seed, device=dev)
            if est[c].sum() > 0 else np.tile(est[c], (opt.bootstrap, 1))
            for c in range(C)
        ]
    for c in range(C):
        if opt.matrix_to_directories:
            cell_dir = os.path.join(out, f"abundance_{c + 1}")
            if os.path.exists(cell_dir) and not os.path.isdir(cell_dir):
                raise ValueError(
                    f"file {cell_dir} exists and is not a directory"
                )
            os.makedirs(cell_dir, exist_ok=True)
            ab_path = os.path.join(cell_dir, "abundance.tsv")
            gene_path = os.path.join(cell_dir, "abundance.gene.tsv")
            h5_path = os.path.join(cell_dir, "abundance.h5")
            bs_fmt = os.path.join(cell_dir, "bs_abundance_{b}.tsv")
            bs_gene_fmt = os.path.join(cell_dir, "bs_abundance.gene_{b}.tsv")
        else:
            ab_path = os.path.join(out, f"abundance_{c + 1}.tsv")
            gene_path = os.path.join(out, f"abundance.gene_{c + 1}.tsv")
            h5_path = os.path.join(out, f"abundance_{c + 1}.h5")
            bs_fmt = os.path.join(out, f"bs_abundance_{c + 1}_{{b}}.tsv")
            bs_gene_fmt = os.path.join(out, f"bs_abundance.gene_{c + 1}_{{b}}.tsv")
        writers.write_abundance_tsv(
            ab_path, target_names, target_lens, eff_lens[c], est[c],
            counts_to_tpm(est[c], eff_lens[c]),
        )
        if model is not None:
            _write_gene_tsv(gene_path, model, est[c], eff_lens[c])
        if not opt.plaintext:
            from ..io.h5 import HAVE_H5PY, write_abundance_h5

            if HAVE_H5PY:
                write_abundance_h5(
                    h5_path,
                    est_counts=est[c],
                    target_names=target_names,
                    lengths=target_lens,
                    eff_lens=eff_lens[c],
                    fld=np.asarray(_tcc_fld_counts(opt), np.uint32),
                    bias_observed=np.ones(4096, np.int32),
                    bias_normalized=np.ones(4096, np.float64),
                    num_bootstrap=opt.bootstrap,
                    num_processed=0,
                    kallisto_version="",
                    index_version=REFERENCE_INDEX_VERSION,
                    start_time="",
                    call="",
                    bootstraps=bs_all[c] if bs_all is not None else None,
                )
        if opt.plaintext and bs_all is not None:
            for b in range(opt.bootstrap):
                writers.write_abundance_tsv(
                    bs_fmt.format(b=b),
                    target_names, target_lens, eff_lens[c], bs_all[c][b],
                    counts_to_tpm(bs_all[c][b], eff_lens[c]),
                )
                if model is not None:
                    _write_gene_tsv(
                        bs_gene_fmt.format(b=b), model, bs_all[c][b], eff_lens[c]
                    )


def _tcc_fld_counts(opt) -> np.ndarray:
    if opt.fld_mean != 0.0:
        return trunc_gaussian_counts(
            0, MAX_FRAG_LEN, opt.fld_mean, opt.fld_sd, 10000
        )
    return np.zeros(MAX_FRAG_LEN, np.uint32)


def _write_mtx(path: str, mat: np.ndarray, dense_mask: Optional[np.ndarray] = None):
    """MatrixMarket writer matching writeSparseBatchMatrix
    (reference: src/PlaintextWriter.h:73-105): nonzero entries, 1-based,
    row-major order, C++ default double formatting."""
    mask = mat != 0 if dense_mask is None else dense_mask
    rows, cols = np.nonzero(mask)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{mat.shape[0]}\t{mat.shape[1]}\t{rows.shape[0]}\n")
        for r, c in zip(rows, cols):
            f.write(f"{r+1}\t{c+1}\t{writers.cpp_double(mat[r, c])}\n")
