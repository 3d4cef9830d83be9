"""The port's native host runtime: the packed FASTQ reader and the index
build's k-mer helpers (ctypes over csrc/ktio.cpp).

The library is built with g++ at first use into kallisto_tpu_torch/_kbuild/,
one file per source and flags (the name carries their hash, so a build with
-mavx2 is never loaded on a host without AVX2, and several processes can
build at once: each writes a temporary file and renames it).  -mavx2 is
passed where /proc/cpuinfo lists avx2, libdeflate is linked where its header
is installed (else zlib inflates the BGZF blocks too; the batches are the
same).  There is no fallback: a library that cannot be built or loaded
raises.  Every helper takes its thread count explicitly.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from .fastx import PackedBatch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ktio.cpp")
_BUILD_DIR = os.path.join(_PKG, "_kbuild")
_ABI = 1
_CXX = "g++"
_DEFLATE_HEADER = "/usr/include/libdeflate.h"

_lock = threading.Lock()
_libs: Dict[bool, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_int64


def _flags(zlib_only: bool):
    try:
        with open("/proc/cpuinfo") as f:
            avx2 = "avx2" in f.read()
    except OSError:
        avx2 = False
    deflate = not zlib_only and os.path.exists(_DEFLATE_HEADER)
    return (["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
            + (["-mavx2"] if avx2 else [])
            + (["-DKTIO_LIBDEFLATE"] if deflate else [])), (
                ["-lz"] + (["-ldeflate"] if deflate else []))


def load(zlib_only: bool = False) -> ctypes.CDLL:
    """Build (once per source and flags) and load the library;
    zlib_only leaves libdeflate out even where it is installed."""
    with _lock:
        lib = _libs.get(zlib_only)
        if lib is not None:
            return lib
        cflags, libs = _flags(zlib_only)
        h = hashlib.sha256()
        with open(_SRC, "rb") as f:
            h.update(f.read())
        h.update(" ".join(cflags + libs).encode())
        out = os.path.join(_BUILD_DIR, f"libktreader_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.run([_CXX, *cflags, _SRC, "-o", tmp, *libs],
                               capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"{_CXX} failed for ktio.cpp:\n"
                                   f"{p.stdout}{p.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        if lib.ktio_abi_version() != _ABI:
            raise RuntimeError("native reader ABI mismatch")
        lib.ktio_open.restype = _P
        lib.ktio_open.argtypes = [ctypes.c_char_p] + [_I] * 5
        lib.ktio_next.restype = _I
        lib.ktio_next.argtypes = [_P] * 8
        lib.ktio_error.restype = ctypes.c_char_p
        lib.ktio_error.argtypes = [_P]
        lib.ktio_close.restype = None
        lib.ktio_close.argtypes = [_P]
        lib.ktio_u64_lookup.restype = None
        lib.ktio_u64_lookup.argtypes = [_P, _LL, _P, _I, _P, _LL, _P, _P, _I]
        lib.ktio_kmer_scan.restype = None
        lib.ktio_kmer_scan.argtypes = [_P, _LL, _I, _P, _P, _P, _I]
        lib.ktio_revcomp.restype = None
        lib.ktio_revcomp.argtypes = [_P, _LL, _I, _P, _I]
        _libs[zlib_only] = lib
        return lib


class NativeFastqReader:
    """Batches of one FASTQ file (plain, gzip or BGZF), read, inflated and
    packed on native threads: io_threads > 1 inflates a BGZF file's blocks
    on io_threads - 1 workers; every batch but the last holds batch_reads
    reads; Lp = max(longest read, min_len) rounded up to pad_to."""

    def __init__(self, path: str, batch_reads: int, pad_to: int = 8,
                 min_len: int = 31, keep_names: bool = False,
                 io_threads: int = 4, zlib_only: bool = False):
        self._h = None
        self._lib = load(zlib_only)
        self.path = path
        if not os.path.exists(path):
            raise FileNotFoundError(2, "No such file or directory", path)
        self._h = self._lib.ktio_open(path.encode(), int(batch_reads),
                                      int(pad_to), int(min_len),
                                      int(keep_names), int(io_threads))
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._keep_names = keep_names
        self._threads = int(io_threads)

    def next_batch(self) -> Optional[PackedBatch]:
        if not self._h:
            return None
        pk = ctypes.POINTER(ctypes.c_uint8)()
        nm = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.POINTER(ctypes.c_int32)()
        nme = ctypes.POINTER(ctypes.c_uint8)()
        noff = ctypes.POINTER(ctypes.c_int32)()
        n = ctypes.c_int32()
        Lp = ctypes.c_int32()
        rc = self._lib.ktio_next(
            self._h, ctypes.byref(pk), ctypes.byref(nm), ctypes.byref(ln),
            ctypes.byref(nme), ctypes.byref(noff), ctypes.byref(n),
            ctypes.byref(Lp))
        if rc == 0:
            return None
        if rc < 0:
            msg = self._lib.ktio_error(self._h).decode()
            if rc == -2:
                raise ValueError(
                    f"malformed FASTQ record in {self.path} ({msg})")
            raise OSError(f"{self.path}: {msg}")
        B, L = n.value, Lp.value
        # copy out: the native buffers are reused by the next call
        packed = np.ctypeslib.as_array(pk, shape=(B, L // 4)).copy()
        nmask = np.ctypeslib.as_array(nm, shape=(B, L // 8)).copy()
        lens = np.ctypeslib.as_array(ln, shape=(B,)).copy()
        names = None
        if self._keep_names:
            off = np.ctypeslib.as_array(noff, shape=(B + 1,))
            nbytes = int(off[-1])
            raw = (bytes(np.ctypeslib.as_array(nme, shape=(nbytes,)))
                   if nbytes else b"")
            names = [raw[off[i]:off[i + 1]] for i in range(B)]
        return PackedBatch(packed, nmask, lens, L, names)

    def close(self):
        if self._h:
            self._lib.ktio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def u64_lookup(keys_mixed_sorted: np.ndarray, bucket_start: np.ndarray,
               p: int, queries: np.ndarray, threads: int):
    """Hashed membership of raw queries in a sorted table of mixed keys
    (index/build.py _KmerLookup): (position in the table, n on a miss;
    hit)."""
    lib = load()
    keys = _c(keys_mixed_sorted, np.uint64)
    bs = _c(bucket_start, np.int64)
    q = _c(queries, np.uint64)
    out_idx = np.empty(q.shape[0], np.int64)
    out_hit = np.empty(q.shape[0], np.uint8)
    lib.ktio_u64_lookup(keys.ctypes.data, keys.shape[0], bs.ctypes.data,
                        int(p), q.ctypes.data, q.shape[0],
                        out_idx.ctypes.data, out_hit.ctypes.data,
                        int(threads))
    return out_idx, out_hit.astype(bool)


def kmer_scan(codes: np.ndarray, k: int, threads: int):
    """Canonical k-mers of every window of a code vector: (canon, is_fw,
    valid); canon and is_fw are defined where valid."""
    lib = load()
    c = _c(codes, np.uint8)
    W = c.shape[0] - k + 1
    if W <= 0:
        return np.empty(0, np.uint64), np.empty(0, bool), np.empty(0, bool)
    canon = np.empty(W, np.uint64)
    is_fw = np.empty(W, np.uint8)
    valid = np.empty(W, np.uint8)
    lib.ktio_kmer_scan(c.ctypes.data, c.shape[0], int(k), canon.ctypes.data,
                       is_fw.ctypes.data, valid.ctypes.data, int(threads))
    return canon, is_fw.astype(bool), valid.astype(bool)


def revcomp64(kmers: np.ndarray, k: int, threads: int) -> np.ndarray:
    """Reverse complements of packed k-mers (low 2k bits)."""
    lib = load()
    x = _c(kmers, np.uint64)
    out = np.empty(x.shape[0], np.uint64)
    lib.ktio_revcomp(x.ctypes.data, x.shape[0], int(k), out.ctypes.data,
                     int(threads))
    return out
