"""A configuration's deployment: its transcriptome and the program's index
of it, made once per checkout into benchmark/.cache/ and reused.

The cache key holds the transcriptome's parameters, k and a hash of the
program's index code (kallisto_tpu_torch/index/*.py), so that a change to
the index build makes a new index.  Files are written under a temporary
name and renamed, so a run that is cut leaves no half-written entry.
"""

import glob
import gzip
import hashlib
import json
import os
import time
from unittest import mock

import numpy as np

from . import traffic

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")


def _index_code_hash(program_dir: str) -> str:
    h = hashlib.sha256()
    for p in sorted(glob.glob(os.path.join(program_dir, "index", "*.py"))):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# the configuration's keys that make its transcriptome
TX_KEYS = ("n_genes", "isoforms_per_gene", "exons_per_gene", "exon_len_mean",
           "transcriptome_seed")


def _tx_params(config: dict) -> dict:
    return {k: config[k] for k in TX_KEYS}


def cache_key(config: dict, program_dir: str) -> str:
    spec = json.dumps(dict(_tx_params(config), k=config["k"]), sort_keys=True)
    return (hashlib.sha256(spec.encode()).hexdigest()[:16] + "-"
            + _index_code_hash(program_dir))


def fasta_path(config: dict) -> str:
    spec = json.dumps(_tx_params(config), sort_keys=True)
    key = hashlib.sha256(spec.encode()).hexdigest()[:16]
    path = os.path.join(CACHE_DIR, f"transcripts-{key}.fasta.gz")
    if not os.path.exists(path):
        os.makedirs(CACHE_DIR, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        p = _tx_params(config)
        traffic.transcriptome(tmp, p["n_genes"], p["isoforms_per_gene"],
                              p["exons_per_gene"], p["exon_len_mean"],
                              p["transcriptome_seed"])
        os.replace(tmp, path)
    return path


def read_pool(path: str) -> traffic.Pool:
    """The FASTA's sequences as written (no clipping), as codes."""
    seqs, parts = [], []
    with gzip.open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                if parts:
                    seqs.append(b"".join(parts))
                parts = []
            elif line:
                parts.append(line)
    if parts:
        seqs.append(b"".join(parts))
    lut = np.full(256, 255, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = [lut[np.frombuffer(s, np.uint8)] for s in seqs]
    if any((c > 3).any() for c in codes):
        raise ValueError(f"{path}: a base other than A, C, G, T")
    return traffic.Pool(codes)


def program_index(config: dict, program_dir: str, log):
    """(FASTA, the program's index of the configuration, seconds spent
    filling the cache): the index loaded from the cache, or built with the
    program's own build_index and saved there with its save_index (0 s
    filled when both were cached)."""
    from kallisto_tpu_torch.index import build_index, load_index, save_index

    t0 = time.perf_counter()
    fasta = fasta_path(config)
    path = os.path.join(CACHE_DIR, f"index-{cache_key(config, program_dir)}.npz")
    if os.path.exists(path):
        t1 = time.perf_counter()
        index = load_index(path)
        log(f"index loaded from the cache in {time.perf_counter() - t1:.1f} s")
        return fasta, index, 0.0
    index = build_index([fasta], k=config["k"], threads=0)
    t1 = time.perf_counter()
    tmp = path + f".tmp{os.getpid()}"
    # the cache is read back only by this checkout: stored, not deflated,
    # the save takes seconds instead of a minute and every later run's
    # load skips inflating it
    with mock.patch.object(np, "savez_compressed", np.savez):
        save_index(index, tmp)
    os.replace(tmp, path)
    log(f"index built in {t1 - t0:.1f} s and saved in "
        f"{time.perf_counter() - t1:.1f} s ({index.num_trans} targets, "
        f"{index.num_kmers} k-mers)")
    return fasta, index, time.perf_counter() - t0
