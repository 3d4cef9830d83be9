"""Host wave 1: anchor verification of uniform-length batches on the host.

Port of kallisto_tpu/ops/hostprobe.py over a host probe of the port's own,
csrc/hostprobe.cpp (host C++, built with g++ at first use into _kbuild/
and bound with ctypes).  A few k-mer lookups per mate either prove that
the read matches one unitig stretch (the anchor kernel's theorem,
ops/anchor.py) or send it to wave 2 on the card.  Verified reads are
reduced on the host to a key histogram in the resolver's exemplar layout;
only the failing reads go to the card: a pair with one failed mate as that
mate's codes plus the other's 8-byte summary (kernel K), a pair with both
failed as both mates (kernel D).  quant/pipeline.py merges the host and
card keys by first read, so EC numbering is that of the per-read route.

There is no fallback: a probe that cannot be built or loaded raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional

import numpy as np

from .anchor import n_anchors_for
from .pseudoalign import cached_probe_layout, pos_tables_from_host

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "hostprobe.cpp")
_BUILD_DIR = os.path.join(_PKG, "_kbuild")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int32
_LL = ctypes.c_int64


def load() -> ctypes.CDLL:
    """Build (g++, once per source and flags) and load the host probe."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        with open(_SRC, "rb") as f:
            h.update(f.read())
        h.update(" ".join(_FLAGS).encode())
        out = os.path.join(_BUILD_DIR, f"libhostprobe_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                               capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed for hostprobe.cpp:\n"
                                   f"{p.stdout}{p.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        if lib.hostprobe_abi_version() != _ABI:
            raise RuntimeError("host probe ABI mismatch")
        lib.hostprobe_wave1.restype = _P
        lib.hostprobe_wave1.argtypes = (
            [_P] * 2 + [_I] + [_P] * 7 + [_LL] + [_P] * 4 + [_LL]
            + [_I] * 5 + [_P] + [_I] * 4 + [_P] * 7)
        lib.hostprobe_nkeys.restype = _LL
        lib.hostprobe_nkeys.argtypes = [_P]
        lib.hostprobe_width.restype = _I
        lib.hostprobe_width.argtypes = [_P]
        lib.hostprobe_fetch.restype = None
        lib.hostprobe_fetch.argtypes = [_P] * 6
        lib.hostprobe_free.restype = None
        lib.hostprobe_free.argtypes = [_P]
        _lib = lib
        return lib


class HostKeys(NamedTuple):
    """One batch's wave-1 outcome (JAX ops/hostprobe.py HostKeys)."""

    fail_idx: np.ndarray   # [n_fail] int32 ascending read indices -> card
    fail_side: np.ndarray  # [n_fail] uint8: 1/2 = only that mate failed
    #                        (the other's summary packs), 3 = both go
    fail_vsum: np.ndarray  # [n_fail, 2] int32 verified-mate summary
    #                        (blo, upos0<<5 | span<<1 | strand); side 1/2
    h128: np.ndarray       # [K, 2] int64 key hashes (host namespace)
    occ: np.ndarray        # [K] int64 multiplicity
    first_idx: np.ndarray  # [K] int64 first read, ascending
    exemplars: np.ndarray  # [K, W] int32 key content (resolver layout)
    # per-read outputs (None unless perread=True): the key word h1 (0 for
    # failing reads), each mate's (f_block, upos0<<1 | strand) and the
    # mapPair fragment length (-1 = not inferable or failing)
    read_h1: Optional[np.ndarray] = None   # [n] uint64
    vinfo: Optional[np.ndarray] = None     # [n, 4] int32
    read_tl: Optional[np.ndarray] = None   # [n] int32


class HostProbe:
    """Per-run host probe over the index's sorted probe tables."""

    def __init__(self, index, min_range: int = 0, strand_key: bool = False,
                 pos_key: bool = False, pos_fl: int = -1, R: int = 16,
                 n_threads: int = 0):
        self._lib = load()
        layout = cached_probe_layout(index)
        order = layout.order

        def c(a, dtype):
            return np.ascontiguousarray(a, dtype)

        self._mk = c(layout.mk, np.uint64)
        self._bucket_start = c(layout.bucket_start, np.int64)
        self._p = int(layout.p)
        self._uid = c(index.kmer_uid[order], np.int32)
        self._pos = c(index.kmer_pos[order], np.int32)
        self._fw = c(index.kmer_fw[order], np.uint8)
        self._block = c(index.kmer_block[order], np.int32)
        self._block_ec = c(index.block_ec, np.int32)
        self.k = index.k
        self.R = R
        self.min_range = min_range
        # tail layout of ops/pseudoalign.py gather_exemplars_plain
        self.tail_mode = 2 if pos_key else (1 if strand_key else 0)
        self.pos_fl = pos_fl if pos_key else -1
        self._pf_ptr = self._pf_base = None
        self._pf_np = 0
        if pos_key and pos_fl >= 0:
            pf_ptr, pf_base, _ = pos_tables_from_host(index)
            self._pf_ptr = c(pf_ptr, np.int32)
            self._pf_base = c(pf_base, np.int32)
            self._pf_np = pf_base.shape[0] // 2
        self.n_threads = n_threads if n_threads > 0 else (os.cpu_count() or 1)

    @staticmethod
    def _ptr(a: Optional[np.ndarray]):
        return None if a is None else a.ctypes.data

    def _probe(self, b1, b2, rl: int, perread: bool) -> HostKeys:
        n = int(b1.lens.shape[0])
        if not 0 < rl <= b1.Lp or rl < self.k:
            raise ValueError(f"read length {rl} outside [k, Lp]")
        na = n_anchors_for(rl, self.k)
        wlast = rl - self.k
        ws = np.array([(wlast * j) // (na - 1) for j in range(na)], np.int32)
        fail_idx = np.empty(n, np.int32)
        fail_side = np.empty(n, np.uint8)
        fail_vsum = np.empty((n, 2), np.int32)
        read_h1 = np.zeros(n, np.uint64) if perread else None
        vinfo = np.zeros((n, 4), np.int32) if perread else None
        read_tl = np.full(n, -1, np.int32) if perread else None
        n_fail = ctypes.c_int64()
        p1 = np.ascontiguousarray(b1.packed)
        n1 = np.ascontiguousarray(b1.nmask)
        p2 = n2 = None
        if b2 is not None:
            p2 = np.ascontiguousarray(b2.packed)
            n2 = np.ascontiguousarray(b2.nmask)
        h = self._lib.hostprobe_wave1(
            self._mk.ctypes.data, self._bucket_start.ctypes.data, self._p,
            self._uid.ctypes.data, self._pos.ctypes.data,
            self._fw.ctypes.data, self._block.ctypes.data,
            self._block_ec.ctypes.data, self._ptr(self._pf_ptr),
            self._ptr(self._pf_base), self._pf_np,
            p1.ctypes.data, n1.ctypes.data, self._ptr(p2), self._ptr(n2),
            n, b1.Lp, rl, self.k, self.R, na, ws.ctypes.data,
            self.min_range, self.tail_mode, self.pos_fl, self.n_threads,
            fail_idx.ctypes.data, fail_side.ctypes.data,
            fail_vsum.ctypes.data, ctypes.byref(n_fail),
            self._ptr(read_h1), self._ptr(vinfo), self._ptr(read_tl),
        )
        if not h:
            raise ValueError(f"host probe refused R={self.R}")
        try:
            K = self._lib.hostprobe_nkeys(h)
            W = self._lib.hostprobe_width(h)
            h1 = np.empty(K, np.uint64)
            h2 = np.empty(K, np.uint64)
            first = np.empty(K, np.int64)
            count = np.empty(K, np.int64)
            ex = np.empty((K, W), np.int32)
            if K:
                self._lib.hostprobe_fetch(
                    h, h1.ctypes.data, h2.ctypes.data, first.ctypes.data,
                    count.ctypes.data, ex.ctypes.data)
        finally:
            self._lib.hostprobe_free(h)
        nf = int(n_fail.value)
        return HostKeys(
            fail_idx=fail_idx[:nf].copy(),
            fail_side=fail_side[:nf].copy(),
            fail_vsum=fail_vsum[:nf].copy(),
            h128=np.stack([h1.view(np.int64), h2.view(np.int64)], axis=1),
            occ=count, first_idx=first, exemplars=ex,
            read_h1=read_h1, vinfo=vinfo, read_tl=read_tl,
        )

    def probe_pair(self, b1, b2, rl: int, perread: bool = False) -> HostKeys:
        """Wave 1 of both mates of a uniform-length pair batch."""
        if b1.Lp != b2.Lp:
            raise ValueError("mates of a pair batch differ in padded length")
        return self._probe(b1, b2, rl, perread)

    def probe_single(self, b1, rl: int, perread: bool = False) -> HostKeys:
        return self._probe(b1, None, rl, perread)
