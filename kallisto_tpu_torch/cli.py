"""kallisto-compatible command line of the PyTorch/CUDA port.

    python -m kallisto_tpu_torch.cli index -i idx.npz transcripts.fasta.gz
    python -m kallisto_tpu_torch.cli quant -i idx.npz -o out r1.fq.gz r2.fq.gz

Mirrors the `index` and `quant` subcommands of kallisto_tpu/cli.py (the
reference's src/main.cpp) for what the port supports.  `--device` picks
the card (default) or the CPU; without a card the default raises.  The
.npz index format is shared with the JAX package both ways.
"""

import argparse
import sys


def _cmd_index(args):
    from .index import build_index, save_index

    if args.kmer_size % 2 == 0 or not (3 <= args.kmer_size <= 31):
        sys.exit(f"Error: invalid k-mer size {args.kmer_size}, "
                 "must be odd and in [3, 31]")
    index = build_index(
        args.fasta,
        k=args.kmer_size,
        make_unique=args.make_unique,
        max_ec_size=args.max_ec_size,
        dlist_paths=args.d_list.split(",") if args.d_list else None,
        dlist_overhang=args.d_list_overhang,
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

    if args.single and (args.fragment_length <= 0 or args.sd <= 0):
        sys.exit("Error: fragment length mean and sd must be supplied for "
                 "single-end reads using -l and -s")
    if not args.single and len(args.reads) % 2 != 0:
        sys.exit("Error: paired-end mode requires an even number of FASTQ files")
    if args.fr_stranded and args.rf_stranded:
        sys.exit("Error: cannot specify both --fr-stranded and --rf-stranded")
    strand = "fr" if args.fr_stranded else ("rf" if args.rf_stranded else None)
    opt = Options(
        index_path=args.index,
        output_dir=args.output_dir,
        files=args.reads,
        single_end=args.single,
        fld_mean=args.fragment_length,
        fld_sd=args.sd,
        plaintext=args.plaintext,
        write_index=args.write_index,
        single_overhang=args.single_overhang,
        strand=strand,
        do_union=args.union,
        min_range=args.min_range,
        priors=args.priors or "",
        verbose=args.verbose,
        batch_size=args.batch_size,
        call=" ".join(sys.argv),
    )
    run_quant(opt, device=args.device)


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
    p.add_argument("--plaintext", action="store_true")
    p.add_argument("--write-index", action="store_true")
    p.add_argument("--single-overhang", action="store_true")
    p.add_argument("--fr-stranded", action="store_true")
    p.add_argument("--rf-stranded", action="store_true")
    p.add_argument("--union", action="store_true")
    p.add_argument("-m", "--min-range", type=int, default=1)
    p.add_argument("-p", "--priors", default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--batch-size", type=int, default=1 << 18,
                   help="reads per device batch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("reads", nargs="+")
    p.set_defaults(fn=_cmd_quant)

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
