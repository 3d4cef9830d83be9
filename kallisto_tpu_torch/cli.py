"""kallisto-compatible command line of the PyTorch/CUDA port.

    python -m kallisto_tpu_torch.cli index -i idx.npz transcripts.fasta.gz
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out r1.fq.gz r2.fq.gz
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out -b 100 --seed 42 \
        --bias --plaintext r1.fq.gz r2.fq.gz
    python -m kallisto_tpu_torch.cli bus -i idx.npz -o out -x 10xv2 \
        R1.fq.gz R2.fq.gz
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out --long \
        -P PacBio reads.fq.gz
    python -m kallisto_tpu_torch.cli quant-tcc -i idx.npz -o out \
        -e matrix.ec cells.mtx
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out --pseudobam \
        r1.fq.gz r2.fq.gz
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out --genomebam \
        -g genes.gtf.gz -c chrom.txt r1.fq.gz r2.fq.gz

    python -m kallisto_tpu_torch.cli inspect idx.npz
    python -m kallisto_tpu_torch.cli h5dump -o out_txt out/abundance.h5

Mirrors every subcommand of kallisto_tpu/cli.py (the reference's
src/main.cpp): `index`, `quant`, `bus`, `quant-tcc`, `inspect`, `h5dump`,
`version`, `cite` and the deprecated `pseudo` and `merge` stubs, with
their flags, outputs and exit codes.  `--device` picks the card (default)
or the CPU for the commands that pseudoalign or run the EM; without a
card the default raises.  The .npz index format is shared with the JAX
package both ways.
"""

import argparse
import os
import sys


def _malloc_tune_argv():
    """The argv to re-execute this program with glibc's allocator settings
    (MALLOC_MMAP_MAX_=0, MALLOC_TRIM_THRESHOLD_=-1: large blocks from the
    heap, freed memory kept), as the JAX package's CLI does
    (kallisto_tpu/cli.py:14-31); None when the program is not this CLI run
    as its entry module (`python -m kallisto_tpu_torch.cli`: an importing
    process, such as pytest, is never replaced), when the settings are on
    already, or under KALLISTO_TPU_NO_MALLOC_TUNE=1.  `quant` of 1M pairs
    took 12.70 s with them against 14.83 s without (medians of 8
    alternating processes on one H100, malloc_tune_ab.py)."""
    import __main__

    spec = getattr(__main__, "__spec__", None)
    name = spec.name if spec and spec.name else ""
    if (os.environ.get("KALLISTO_TPU_NO_MALLOC_TUNE") == "1"
            or os.environ.get("MALLOC_MMAP_MAX_") == "0"
            or not name.startswith("kallisto_tpu_torch")):
        return None
    return [sys.executable, "-m", name] + sys.argv[1:]


_ARGV = _malloc_tune_argv()
if _ARGV is not None:
    os.environ["MALLOC_MMAP_MAX_"] = "0"
    os.environ["MALLOC_TRIM_THRESHOLD_"] = "-1"
    os.execv(sys.executable, _ARGV)


def _cmd_version(_args):
    from . import KALLISTO_COMPAT_VERSION, __version__

    print(f"kallisto-tpu, version {__version__} "
          f"(kallisto {KALLISTO_COMPAT_VERSION} compatible)")


def _cmd_cite(_args):
    print(
        "When using this program in your research, please cite\n\n"
        "  Bray, N. L., Pimentel, H., Melsted, P. & Pachter, L.\n"
        "  Near-optimal probabilistic RNA-seq quantification,\n"
        "  Nature Biotechnology 34, 525-527 (2016), doi:10.1038/nbt.3519\n"
    )


def _cmd_h5dump(args):
    from .io.h5 import h5dump

    h5dump(args.h5file, args.output_dir)


def _cmd_inspect(args):
    """Reference-parity index inspection (reference: InspectIndex,
    src/Inspect.h:120-140, and the KmerIndex::load prologue)."""
    import numpy as np

    from .common import REFERENCE_INDEX_VERSION
    from .index import load_index

    index = load_index(args.index)
    # load prologue (stderr, reference: KmerIndex.cpp load chatter)
    print(f"[index] k-mer length: {index.k}", file=sys.stderr)
    print(f"[index] number of targets: {index.num_trans:,}", file=sys.stderr)
    print(f"[index] number of k-mers: {index.kmer_keys.shape[0]:,}",
          file=sys.stderr)
    print(f"[inspect] Index version number = {REFERENCE_INDEX_VERSION}")
    n_unitigs = index.unitig_nkmers.shape[0]
    print(f"[inspect] number of unitigs = {n_unitigs}")
    # the g the reference's Bifrost build would pick for this k
    # (reference: KmerIndex.cpp:581-593); this index looks k-mers up by
    # hash, so g is informational only
    k = index.k
    g = k - 2 if k <= 13 else k - 4 if k <= 17 else k - 6 if k <= 19 else k - 8
    print(f"[inspect] minimizer length = {g}")
    # the largest block EC, and the unitigs whose every block EC is empty
    # (reference: KmerIndex::getECInfo, src/KmerIndex.cpp:215-234)
    row_len = np.diff(index.ec_ptr)
    card = np.where(index.block_ec >= 0,
                    row_len[np.maximum(index.block_ec, 0)], 0)
    max_ec = int(card.max()) if card.size else 0
    nonzero_unitigs = np.unique(index.block_uid[card > 0])
    discarded = n_unitigs - nonzero_unitigs.shape[0]
    print(f"[inspect] max EC size = {max_ec}")
    print(f"[inspect] number of ECs discarded = {discarded}")


def _cmd_deprecated(name):
    def run(_args):
        sys.exit(f"Error: {name} is deprecated (as in kallisto 0.51.1)")

    return run


def _cmd_index(args):
    from .index import build_index, save_index

    if args.kmer_size % 2 == 0 or not (3 <= args.kmer_size <= 31):
        sys.exit(f"Error: invalid k-mer size {args.kmer_size}, "
                 "must be odd and in [3, 31]")
    if args.min_size != -1:
        # the reference's -m sets Bifrost's minimizer length, a build-time
        # tuning knob; this index has no minimizers (sorted-hash k-mer
        # lookup), so the flag cannot change the result
        print("[build] note: -m/--min-size has no effect (this index uses "
              "hashed k-mer lookup, not minimizers)", file=sys.stderr)
    dlist_paths = args.d_list.split(",") if args.d_list else None
    overhang = args.d_list_overhang
    if args.aa and dlist_paths and overhang < 3:
        # reference: main.cpp:140-146
        print(
            "[index] --d-list-overhang was set to 3 (with --aa, the d-list "
            "overhang must be >= 3)",
            file=sys.stderr,
        )
        overhang = 3
    index = build_index(
        args.fasta,
        k=args.kmer_size,
        make_unique=args.make_unique,
        max_ec_size=args.max_ec_size,
        dlist_paths=dlist_paths,
        dlist_overhang=overhang,
        aa=args.aa,
        distinguish=args.distinguish,
        threads=args.threads,
    )
    save_index(index, args.index)
    print(
        f"[build] built index: {index.num_kmers} k-mers, "
        f"{index.num_unitigs} unitigs, {index.num_trans} targets",
        file=sys.stderr,
    )


def _cmd_quant(args):
    from .common import Options
    from .quant.pipeline import run_quant

    if args.single and not args.long and (
        args.fragment_length <= 0 or args.sd <= 0
    ):
        sys.exit("Error: fragment length mean and sd must be supplied for "
                 "single-end reads using -l and -s")
    if not args.single and not args.long and len(args.reads) % 2 != 0:
        sys.exit("Error: paired-end mode requires an even number of FASTQ files")
    if args.long and not (0 < args.threshold < 1):
        print("Threshold not in (0,1). Setting default threshold for "
              "unmapped kmers to 0.8", file=sys.stderr)
        args.threshold = 0.8
    if args.fr_stranded and args.rf_stranded:
        sys.exit("Error: cannot specify both --fr-stranded and --rf-stranded")
    strand = "fr" if args.fr_stranded else ("rf" if args.rf_stranded else None)
    if args.fusion:
        # reference: ProcessReads.cpp:1075-1078 (dead code in 0.51.1)
        sys.exit("Error: fusion detection is not implemented (the reference "
                 "0.51.1 exits with 'TODO: Implement fusion' as well)")
    genomebam = args.genomebam or bool(args.gtf)
    if genomebam and not args.gtf:
        sys.exit("Error: need GTF file for genome alignment")
    opt = Options(
        index_path=args.index,
        output_dir=args.output_dir,
        files=args.reads,
        single_end=args.single,
        fld_mean=args.fragment_length,
        fld_sd=args.sd,
        bootstrap=args.bootstrap_samples,
        seed=args.seed,
        plaintext=args.plaintext,
        write_index=args.write_index,
        single_overhang=args.single_overhang,
        long_read=args.long,
        platform=args.platform,
        threshold=args.threshold,
        bias=args.bias,
        strand=strand,
        do_union=args.union,
        no_jump=args.no_jump,
        min_range=args.min_range,
        pseudobam=args.pseudobam or genomebam,
        genomebam=genomebam,
        gtf_file=args.gtf or "",
        chrom_file=args.chromosomes or "",
        priors=args.priors or "",
        verbose=args.verbose,
        threads=args.threads,
        batch_size=args.batch_size,
        call=" ".join(sys.argv),
    )
    run_quant(opt, device=args.device)


def _cmd_bus(args):
    from .common import Options
    from .sc.bus import run_bus
    from .sc.technologies import TECHNOLOGY_LIST

    if args.list:
        print("List of supported single-cell technologies\n\nshort name\n%s"
              % "\n".join(TECHNOLOGY_LIST))
        return
    if not args.technology and not args.batch:
        # reference: without -x, only batch/bulk modes are valid
        # (src/main.cpp:1056-1059)
        sys.exit('Error: the technology must be specified via -x, use "bulk" '
                 "for regular RNA-seq reads")
    if args.batch and args.reads:
        sys.exit("Error: cannot specify batch mode and supply read files")
    if args.num and args.bam:
        sys.exit("Error: --num is incompatible with --bam")
    if not args.batch and not args.reads:
        sys.exit("Error: Missing read files")
    strand = None
    if args.fr_stranded:
        strand = "fr"
    elif args.rf_stranded:
        strand = "rf"
    opt = Options(
        index_path=args.index,
        output_dir=args.output_dir,
        technology=args.technology,
        files=args.reads,
        strand=strand,
        unstranded=args.unstranded,
        single_end=args.single_end,
        bus_paired=args.bus_paired,
        bus_num=args.num,
        max_num_reads=args.num_reads,
        aa=args.aa,
        batch_file=args.batch or "",
        batch_barcodes=args.batch_barcodes,
        inleaved=args.inleaved,
        tag=args.tag or "",
        bam=args.bam,
        long_read=args.long,
        platform=args.platform,
        threshold=args.threshold,
        dfk_onlist=args.dfk_onlist,
        do_union=args.union,
        no_jump=args.no_jump,
        verbose=args.verbose,
        threads=args.threads,
        batch_size=args.batch_size,
        call=" ".join(sys.argv),
    )
    res = run_bus(opt, device=args.device)
    if res.num_pseudoaligned == 0:
        sys.exit(1)
    if opt.max_num_reads and res.num_processed < opt.max_num_reads:
        print(f"Note: Number of reads processed is less than --numReads: "
              f"{opt.max_num_reads}, returning 1", file=sys.stderr)
        sys.exit(1)


def _cmd_quant_tcc(args):
    from .common import Options
    from .quant.tcc import run_quant_tcc

    if not args.index and not args.txnames:
        sys.exit("Error: either a kallisto index file or a transcripts file "
                 "need to be supplied")
    if args.index and args.txnames:
        sys.exit("Error: cannot supply both a kallisto index file and a "
                 "transcripts file")
    if (args.fragment_length != 0.0 or args.sd != 0.0) and args.fragment_file:
        sys.exit("Error: cannot supply mean or sd while also supplying a "
                 "fragment length distribution file")
    if (args.fragment_length != 0.0) != (args.sd != 0.0):
        sys.exit("Error: cannot supply mean/sd without supplying both -l and -s")
    opt = Options(
        index_path=args.index or "",
        txnames_file=args.txnames or "",
        output_dir=args.output_dir,
        ec_file=args.ec_file,
        tcc_file=args.tcc,
        fld_mean=args.fragment_length,
        fld_sd=args.sd,
        fld_file=args.fragment_file,
        genemap=args.genemap,
        gtf_file=args.gtf or "",
        bootstrap=args.bootstrap_samples,
        seed=args.seed,
        priors=args.priors or "",
        long_read=args.long,
        platform=args.platform,
        plaintext=args.plaintext,
        matrix_to_files=args.matrix_to_files or args.matrix_to_directories,
        matrix_to_directories=args.matrix_to_directories,
        threads=args.threads,
        call=" ".join(sys.argv),
    )
    run_quant_tcc(opt, device=args.device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="kallisto-tpu-torch",
        description="pseudoalignment and RNA-seq quantification on a CUDA card",
    )
    sub = parser.add_subparsers(dest="cmd")

    p = sub.add_parser("index", help="build a transcriptome index")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-k", "--kmer-size", type=int, default=31)
    p.add_argument("--make-unique", action="store_true")
    p.add_argument("--aa", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="threads for the native build kernels (scans, "
                        "hashed lookups); default 1 like the reference")
    p.add_argument("-T", "--tmp", default="tmp")
    p.add_argument("-m", "--min-size", type=int, default=-1)
    p.add_argument("--distinguish", action="store_true")
    p.add_argument("-d", "--d-list", default=None,
                   help="comma-separated FASTA file(s) of sequences to discard")
    p.add_argument("-D", "--d-list-overhang", type=int, default=1)
    p.add_argument("-e", "--max-ec-size", type=int, default=-1)
    p.add_argument("fasta", nargs="+")
    p.set_defaults(fn=_cmd_index)

    p = sub.add_parser("quant", help="run quantification")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("--single", action="store_true")
    p.add_argument("-l", "--fragment-length", type=float, default=0.0)
    p.add_argument("-s", "--sd", type=float, default=0.0)
    p.add_argument("-b", "--bootstrap-samples", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--plaintext", action="store_true")
    p.add_argument("--write-index", action="store_true")
    p.add_argument("--single-overhang", action="store_true")
    p.add_argument("--fr-stranded", action="store_true")
    p.add_argument("--rf-stranded", action="store_true")
    p.add_argument("--bias", action="store_true")
    p.add_argument("--long", action="store_true")
    p.add_argument("-P", "--platform", default="")
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--union", action="store_true")
    p.add_argument("--no-jump", action="store_true")
    p.add_argument("--fusion", action="store_true")
    p.add_argument("--pseudobam", action="store_true")
    p.add_argument("--genomebam", action="store_true")
    p.add_argument("-g", "--gtf", default=None)
    p.add_argument("-c", "--chromosomes", default=None)
    p.add_argument("-m", "--min-range", type=int, default=1)
    p.add_argument("-p", "--priors", default=None)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="devices to spread read batches over (up to the "
                        "card count; the CPU counts as one)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--batch-size", type=int, default=1 << 18,
                   help="reads per device batch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("reads", nargs="+")
    p.set_defaults(fn=_cmd_quant)

    p = sub.add_parser("bus", help="generate BUS files for single-cell data")
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("-x", "--technology", default="")
    p.add_argument("-l", "--list", action="store_true")
    p.add_argument("-B", "--batch", default=None)
    p.add_argument("-b", "--bam", action="store_true")
    p.add_argument("-T", "--tag", default=None)
    p.add_argument("--aa", action="store_true")
    p.add_argument("-n", "--num", action="store_true")
    p.add_argument("-N", "--numReads", type=int, default=0, dest="num_reads")
    p.add_argument("--fr-stranded", action="store_true")
    p.add_argument("--rf-stranded", action="store_true")
    p.add_argument("--unstranded", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="devices to spread read chunks over (up to the "
                        "card count; the CPU counts as one)")
    p.add_argument("--single", action="store_true", dest="single_end")
    p.add_argument("--paired", action="store_true", dest="bus_paired")
    p.add_argument("--long", action="store_true")
    p.add_argument("-r", "--threshold", type=float, default=0.8)
    p.add_argument("-P", "--platform", default="")
    p.add_argument("--inleaved", action="store_true")
    p.add_argument("--batch-barcodes", action="store_true")
    p.add_argument("--dfk-onlist", action="store_true")
    p.add_argument("--union", action="store_true")
    p.add_argument("--no-jump", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--batch-size", type=int, default=1 << 18,
                   help="reads per device batch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("reads", nargs="*")
    p.set_defaults(fn=_cmd_bus)

    p = sub.add_parser("quant-tcc",
                       help="quantify from transcript-compatibility counts")
    p.add_argument("-i", "--index", default="")
    p.add_argument("-T", "--txnames", default="")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("-e", "--ec-file", required=True)
    p.add_argument("-l", "--fragment-length", type=float, default=0.0)
    p.add_argument("-s", "--sd", type=float, default=0.0)
    p.add_argument("-f", "--fragment-file", default="")
    p.add_argument("-g", "--genemap", default="")
    p.add_argument("-G", "--gtf", default="")
    p.add_argument("-b", "--bootstrap-samples", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("-p", "--priors", default=None)
    p.add_argument("--long", action="store_true")
    p.add_argument("-P", "--platform", default="")
    p.add_argument("--plaintext", action="store_true")
    p.add_argument("--matrix-to-files", action="store_true")
    p.add_argument("--matrix-to-directories", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="devices to spread cells over (up to the card "
                        "count; the CPU counts as one)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("tcc")
    p.set_defaults(fn=_cmd_quant_tcc)

    p = sub.add_parser("h5dump", help="convert abundance.h5 to plaintext")
    p.add_argument("-o", "--output-dir", required=True)
    p.add_argument("h5file")
    p.set_defaults(fn=_cmd_h5dump)

    p = sub.add_parser("inspect", help="inspect an index")
    p.add_argument("index")
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("version")
    p.set_defaults(fn=_cmd_version)
    p = sub.add_parser("cite")
    p.set_defaults(fn=_cmd_cite)
    p = sub.add_parser("pseudo", help="deprecated")
    p.set_defaults(fn=_cmd_deprecated("pseudo"))
    p = sub.add_parser("merge", help="deprecated")
    p.set_defaults(fn=_cmd_deprecated("merge"))

    args = parser.parse_args(argv)
    if not args.cmd:
        parser.print_help()
        return 1
    try:
        args.fn(args)
    except (FileNotFoundError, IsADirectoryError) as e:
        sys.exit(f"Error: file not found {e.filename}")
    except (ValueError, NotImplementedError, RuntimeError) as e:
        sys.exit(f"Error: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
