"""Shared constants and the run-options record.

Mirrors the semantic content of the reference's ProgramOptions
(reference: src/common.h:93-209) without its getopt plumbing.
"""

from dataclasses import dataclass, field
from typing import List, Optional

# reference: src/MinCollector.h:15
MAX_FRAG_LEN = 1000

# reference: src/EMAlgorithm.h:19 (std::numeric_limits<double>::denorm_min())
EM_TOLERANCE = 5e-324

# reference: src/EMAlgorithm.h:101-103
EM_ALPHA_LIMIT = 1e-7
EM_ALPHA_CHANGE_LIMIT = 1e-2
EM_ALPHA_CHANGE = 1e-2

# reference: src/KmerIndex.cpp:1011-1013 (defaults when -e / --max-ec-size
# is 0; the reference default of -1 disables capping entirely)
EC_THRESHOLD = 250
EC_SOFT_THRESHOLD = 800
EC_MAX_N_ABOVE_THRESHOLD = 6000

# reference: src/common.h:166-171 defaults
DEFAULT_K = 31
DEFAULT_SEED = 42
DEFAULT_ITERATIONS = 500
DEFAULT_MIN_RANGE = 1

# Index format version for our own on-disk flat format (unrelated to the
# reference's binary INDEX_VERSION 13; we encode the same semantic content
# in a dense npz layout). reference: src/KmerIndex.h:132
INDEX_FORMAT_VERSION = 1
REFERENCE_INDEX_VERSION = 13


@dataclass
class Options:
    """Quantification/run options (subset of reference ProgramOptions)."""

    k: int = DEFAULT_K
    threads: int = 1
    seed: int = DEFAULT_SEED
    iterations: int = DEFAULT_ITERATIONS

    index_path: str = ""
    output_dir: str = ""
    files: List[str] = field(default_factory=list)

    single_end: bool = False
    fld_mean: float = 0.0      # -l; 0 => estimate from pairs
    fld_sd: float = 0.0        # -s
    bootstrap: int = 0         # -b
    plaintext: bool = False
    bias: bool = False
    min_range: int = DEFAULT_MIN_RANGE
    strand: Optional[str] = None   # None | 'fr' | 'rf'
    single_overhang: bool = False
    do_union: bool = False
    no_jump: bool = False
    long_read: bool = False
    platform: str = ""
    threshold: float = 0.8          # --threshold: unmapped-kmer novelty cutoff
    priors: str = ""
    verbose: bool = False
    write_index: bool = False
    make_unique: bool = False
    aa: bool = False
    distinguish: bool = False
    dfk_onlist: bool = False
    max_ec_size: int = -1
    technology: str = ""            # -x for bus mode
    bus_paired: bool = False        # bus --paired
    bus_num: bool = False           # bus -n: read number in BUS flags column
    max_num_reads: int = 0          # bus -N: cap on reads processed
    unstranded: bool = False
    # bus input surface (reference: ParseOptionsBus, src/main.cpp:545-800)
    batch_file: str = ""            # -B: per-batch file list
    batch_barcodes: bool = False    # --batch-barcodes
    inleaved: bool = False          # --inleaved interleaved FASTQ
    tag: str = ""                   # -T: 5' UMI tag sequence
    bam: bool = False               # -b: BAM input
    genomebam: bool = False
    pseudobam: bool = False
    gtf_file: str = ""
    chrom_file: str = ""

    # quant-tcc inputs (reference: ParseOptionsTCCQuant, main.cpp:394-540)
    ec_file: str = ""
    tcc_file: str = ""
    fld_file: str = ""
    genemap: str = ""
    txnames_file: str = ""
    matrix_to_files: bool = False
    matrix_to_directories: bool = False

    # device execution controls (no reference equivalent)
    batch_size: int = 1 << 18       # reads per device batch
    device_parity: bool = True      # f64 EM accumulation
    n_devices: int = 0              # 0 = derive from threads (mesh DP)

    call: str = "kallisto-tpu"      # command line echoed into run_info.json

    @property
    def paired(self) -> bool:
        return not self.single_end and not self.long_read
