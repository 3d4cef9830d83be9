"""Native EC resolution of a batch's first-seen keys (ctypes over
csrc/ecresolve.cpp).

One call resolves every new key of a batch by EcResolver.resolve_rows's
rules (sorted intersection of each mate's rows, non-strict pairing, the
off-list mask) and hands back the batch's distinct transcript sets in the
order of their first key, so that the resolver numbers new ECs as a
key-by-key loop would.  The library is built with g++ at first use into
kallisto_tpu_torch/_kbuild/, one file per source and flags.  There is no
fallback: a library that cannot be built or loaded raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ecresolve.cpp")
_BUILD_DIR = os.path.join(_PKG, "_kbuild")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_ABI = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int32
_LL = ctypes.c_int64


def load() -> ctypes.CDLL:
    """Build (g++, once per source and flags) and load the resolver."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        with open(_SRC, "rb") as f:
            h.update(f.read())
        h.update(" ".join(_FLAGS).encode())
        out = os.path.join(_BUILD_DIR, f"libecresolve_{h.hexdigest()[:16]}.so")
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                               capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed for ecresolve.cpp:\n"
                                   f"{p.stdout}{p.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        if lib.ecr_abi_version() != _ABI:
            raise RuntimeError("EC resolver ABI mismatch")
        lib.ecr_new.restype = _P
        lib.ecr_new.argtypes = [_P, _P, _LL, _I, _I]
        lib.ecr_resolve.restype = _LL
        lib.ecr_resolve.argtypes = [_P, _P, _LL, _I, _I, _I, _P]
        lib.ecr_ntx.restype = _LL
        lib.ecr_ntx.argtypes = [_P]
        lib.ecr_fetch.restype = None
        lib.ecr_fetch.argtypes = [_P, _P, _P]
        lib.ecr_free.restype = None
        lib.ecr_free.argtypes = [_P]
        _lib = lib
        return lib


class NativeKeySets:
    """The native resolver over one index's EC-row CSR (kept alive here
    while the native side reads it)."""

    def __init__(self, ec_ptr: np.ndarray, ec_tx: np.ndarray,
                 num_onlist: int, mask_offlist: bool):
        self._lib = load()
        self._ptr = np.ascontiguousarray(ec_ptr, np.int64)
        self._tx = np.ascontiguousarray(ec_tx, np.int32)
        self._h = self._lib.ecr_new(
            self._ptr.ctypes.data, self._tx.ctypes.data,
            self._ptr.shape[0] - 1, int(num_onlist), int(mask_offlist))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ecr_free(h)

    def resolve(self, keys: np.ndarray, R: int, paired: bool
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """keys [n, W] int32 in the exemplar layout -> (key_set [n] int64:
        each key's index into sets, -1 = no set; sets: the distinct sorted
        transcript sets, int32 views of one buffer, in first-key order)."""
        keys = np.ascontiguousarray(keys, np.int32)
        n, W = keys.shape
        if W < (2 * R + 1 if paired else R + 1):
            raise ValueError(f"keys of width {W} hold no flags at R={R}")
        key_set = np.empty(n, np.int32)
        nsets = self._lib.ecr_resolve(self._h, keys.ctypes.data, n, W, R,
                                      int(paired), key_set.ctypes.data)
        if nsets < 0:
            raise ValueError("a key names an EC row outside the index")
        ptr = np.empty(nsets + 1, np.int64)
        tx = np.empty(self._lib.ecr_ntx(self._h), np.int32)
        self._lib.ecr_fetch(self._h, ptr.ctypes.data, tx.ctypes.data)
        bounds = ptr.tolist()
        sets = [tx[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        return key_set.astype(np.int64), sets
