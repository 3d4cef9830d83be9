"""Build, bind and count the hand-written CUDA kernels of the port.

Each source in ``kallisto_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The build
happens at first use, into ``kallisto_tpu_torch/_kbuild/`` (gitignored),
with one ``nvcc`` per source, all started together; a library is named by
the hash of its source and flags, so an unchanged source is not rebuilt.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises
when the C function returns a non-zero ``cudaError_t``, and adds one to
``LAUNCHES[name]`` -- the count that shows a run went through the kernel.
There is no fallback: a CPU tensor never reaches these functions (the
dispatching callers send it to the plain PyTorch version instead), and a
failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kbuild")

# kernel name -> (source file, extra nvcc flags)
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "pseudoalign_side": ("pseudoalign.cu", ()),
    "read_keys": ("read_keys.cu", ()),
    # --fmad=false: no a*b + c contraction, so the f64 EM is bitwise equal
    # to its plain version
    "em_step": ("em.cu", ("--fmad=false",)),
}

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "pseudoalign_side": [_P] * 7 + [_LL, _I] + [_P] * 3 + [_I] * 4
    + [_P] * 10 + [_P],
    "read_keys": [_P, _I, _P, _P, _P, _I, _P, _P] + [_P] * 8
    + [_I, _I, _P, _P, _P],
    "em_step": [_P] * 11 + [_I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Tuple[str, list]:
    src, extra = SOURCES[name]
    src_path = os.path.join(CSRC, src)
    flags = list(_NVCC_FLAGS) + list(extra)
    h = hashlib.sha256()
    with open(src_path, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    return out, [src_path] + flags


def build_all() -> float:
    """Compile (in parallel) and load every kernel library not yet loaded.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in todo:
            out, args = _lib_path(name)
            if os.path.exists(out):
                procs.append((name, out, None, None))
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.Popen(
                [_nvcc()] + args + ["-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            procs.append((name, out, tmp, p))
        errors = []
        for name, out, tmp, p in procs:
            if p is None:
                continue
            so, se = p.communicate()
            log = (so + se).decode(errors="replace").strip()
            if p.returncode != 0:
                errors.append(f"nvcc failed for {name}:\n{log}")
                continue
            if log:
                print(f"[kernels] {name}: {log}", flush=True)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name, out, _, _ in procs:
            lib = ctypes.CDLL(out)
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return time.perf_counter() - t0


def _fn(name: str):
    if name not in _libs:
        build_all()
    return getattr(_libs[name], name)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


# ---------------------------------------------------------------- kernel A


def pseudoalign_side(didx, packed: torch.Tensor, nmask: torch.Tensor,
                     lens: torch.Tensor, k: int, L: int, R: int):
    """Kernel A on one mate's packed batch.  Returns the ten SideResult
    fields as a tuple of CUDA tensors (rows, n_rows, has_hits, overflow,
    f_uid, f_block, f_upos, f_rpos, f_strand, rng)."""
    dev = didx.kmer_hkeys.device
    B = int(lens.shape[0])
    if L % 8 or L < k:
        raise ValueError(f"padded length {L} must be a multiple of 8 and >= k")
    _check(packed, "packed", torch.uint8, (B, L // 4), dev)
    _check(nmask, "nmask", torch.uint8, (B, L // 8), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    N = int(didx.kmer_hkeys.shape[0])
    _check(didx.kmer_hkeys, "kmer_hkeys", torch.int64, (N,), dev)
    _check(didx.bucket_start, "bucket_start", torch.int32,
           ((1 << didx.p) + 1,), dev)
    for nm in ("kmer_uid", "kmer_pos", "kmer_block", "kmer_ec"):
        _check(getattr(didx, nm), nm, torch.int32, (N,), dev)
    _check(didx.kmer_fw, "kmer_fw", torch.bool, (N,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out = (
        torch.empty((B, R), **i32), torch.empty(B, **i32),
        torch.empty(B, **b8), torch.empty(B, **b8),
        torch.empty(B, **i32), torch.empty(B, **i32), torch.empty(B, **i32),
        torch.empty(B, **i32), torch.empty(B, **b8), torch.empty(B, **i32),
    )
    fn = _fn("pseudoalign_side")
    err = fn(
        _ptr(didx.kmer_hkeys), _ptr(didx.bucket_start), _ptr(didx.kmer_uid),
        _ptr(didx.kmer_pos), _ptr(didx.kmer_fw), _ptr(didx.kmer_block),
        _ptr(didx.kmer_ec), N, didx.p,
        _ptr(packed), _ptr(nmask), _ptr(lens), B, L, k, R,
        *[_ptr(t) for t in out], _stream(),
    )
    _raise_on(err, "pseudoalign_side")
    LAUNCHES["pseudoalign_side"] += 1
    return out


# ---------------------------------------------------------------- kernel B


def read_keys(s1, s2, k: int):
    """Kernel B.  Paired (s2 given): returns (h [B, 2] int64, tl [B] int32);
    single-end: (h, None)."""
    dev = s1.rows.device
    B, R1 = (int(x) for x in s1.rows.shape)
    _check(s1.rows, "rows1", torch.int32, (B, R1), dev)
    for nm in ("has_hits", "overflow"):
        _check(getattr(s1, nm), nm + "1", torch.bool, (B,), dev)
    h = torch.empty((B, 2), dtype=torch.int64, device=dev)
    tl = None
    if s2 is not None:
        R2 = int(s2.rows.shape[1])
        _check(s2.rows, "rows2", torch.int32, (B, R2), dev)
        for s, m in ((s1, "1"), (s2, "2")):
            for nm in ("f_upos", "f_rpos", "f_block"):
                _check(getattr(s, nm), nm + m, torch.int32, (B,), dev)
            for nm in ("has_hits", "overflow", "f_strand"):
                _check(getattr(s, nm), nm + m, torch.bool, (B,), dev)
        tl = torch.empty(B, dtype=torch.int32, device=dev)
        args = (
            _ptr(s1.rows), R1, _ptr(s1.has_hits), _ptr(s1.overflow),
            _ptr(s2.rows), R2, _ptr(s2.has_hits), _ptr(s2.overflow),
            _ptr(s1.f_upos), _ptr(s1.f_rpos), _ptr(s1.f_block),
            _ptr(s1.f_strand), _ptr(s2.f_upos), _ptr(s2.f_rpos),
            _ptr(s2.f_block), _ptr(s2.f_strand),
        )
    else:
        args = (
            _ptr(s1.rows), R1, _ptr(s1.has_hits), _ptr(s1.overflow),
            None, 0, None, None,
        ) + (None,) * 8
    err = _fn("read_keys")(*args, k, B, _ptr(h), _ptr(tl), _stream())
    _raise_on(err, "read_keys")
    LAUNCHES["read_keys"] += 1
    return h, tl


# ---------------------------------------------------------------- kernel C


def em_step(alpha: torch.Tensor, prob, zero_input: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C: one EM update from `alpha` (the final-round zeroing applied
    to it first when zero_input).  `prob` is a DeviceEmProblem.  Returns
    (next_alpha [T] f64, changed [1] int32 -- the change count, on the card)."""
    dev = alpha.device
    T, E = prob.num_trans, prob.num_multi
    M = int(prob.flat_tx.shape[0])
    _check(alpha, "alpha", torch.float64, (T,), dev)
    _check(prob.singleton_alpha, "singleton_alpha", torch.float64, (T,), dev)
    _check(prob.inv_eff, "inv_eff", torch.float64, (T,), dev)
    _check(prob.flat_tx, "flat_tx", torch.int32, (M,), dev)
    _check(prob.ec_ptr, "ec_ptr", torch.int64, (E + 1,), dev)
    _check(prob.multi_counts, "multi_counts", torch.float64, (E,), dev)
    _check(prob.tx_ptr, "tx_ptr", torch.int64, (T + 1,), dev)
    _check(prob.tx_ec, "tx_ec", torch.int32, (M,), dev)
    nxt = torch.empty(T, dtype=torch.float64, device=dev)
    scale = torch.empty(max(E, 1), dtype=torch.float64, device=dev)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    err = _fn("em_step")(
        _ptr(alpha), _ptr(nxt), _ptr(prob.singleton_alpha), _ptr(prob.inv_eff),
        _ptr(prob.flat_tx), _ptr(prob.ec_ptr), _ptr(prob.multi_counts),
        _ptr(prob.tx_ptr), _ptr(prob.tx_ec), _ptr(scale), _ptr(changed),
        T, E, int(bool(zero_input)), _stream(),
    )
    _raise_on(err, "em_step")
    LAUNCHES["em_step"] += 1
    return nxt, changed
