"""Build, bind and count the hand-written CUDA kernels of the port.

Each source in ``kallisto_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The build
happens at first use, into ``kallisto_tpu_torch/_kbuild/`` (gitignored),
with one ``nvcc`` per source, all started together; a library is named by
the hash of its source, the headers of ``csrc/`` and its flags, so an
unchanged source is not rebuilt.  Several kernels may share a source (A's
two waves, A on codes, D, I's two waves, J, K and L; E and F) or a header
(B and E share the read key, ``csrc/keys.cuh``).  Kernels A, D, I, J, K and L take the device index in
either layout
(ops/pseudoalign.py DeviceIndex or PaddedDeviceIndex) as one IndexView.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` on its inputs' device, launches with that
device made current and on that device's current stream (``_launch``: a
shard on cuda:1 is never launched from cuda:0), raises
when the C function returns a non-zero ``cudaError_t``, and adds one to
``LAUNCHES[name]`` -- the count that shows a run went through the kernel.
Kernel A's one C call launches its two waves, counted as
``pseudoalign_side`` and ``pseudoalign_side_wave2``, and A on codes' as
``pseudoalign_codes`` and ``pseudoalign_codes_wave2``; kernel E's C function
``compact_keys`` (the compact key fused into the key table) counts as
``key_histogram``, or ``key_histogram_slots`` with per-read slots;
kernel H runs as the epilogue of kernel B's launch (``read_keys`` with
``bias=``), counted as ``read_keys`` and ``bias_hexamers``; kernel L
on a bucketed index's packed entries counts as ``lookup_kmers``; A, A
on codes, B and E given no reads and F given no keys launch nothing and
count nothing.  A on codes and K take an optional counter of the windows
their covered-interval core probed (``probes``).  Kernel G's loop replays rounds captured in a CUDA graph (EmGraph): each
replay adds the rounds it holds.
There is no fallback: a CPU tensor never reaches these functions (the
dispatching callers send it to the plain PyTorch version instead), and a
failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Dict, Optional, Tuple, Union

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_kbuild")

# row-list entries of a read that kernel J keeps in shared memory (its
# KJ_SLIST, given to the compiler); long_plan spills the rest
LONG_SLIST = 512

# -Xptxas -v: the build prints each probing kernel's registers and spills
# (the register counts csrc/pseudoalign.cu's header comment cites)
_PSEUDOALIGN = ("pseudoalign.cu", ("-Xptxas", "-v", f"-DKJ_SLIST={LONG_SLIST}"))

# -Xptxas -v for kernels E and F too (their registers, PERF.md)
_COMPACT = ("compact.cu", ("-Xptxas", "-v"))

# kernel name -> (source file, extra nvcc flags)
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "pseudoalign_side": _PSEUDOALIGN,
    "pseudoalign_codes": _PSEUDOALIGN,
    "read_keys": ("read_keys.cu", ("-Xptxas", "-v")),
    "pseudoalign_turbo": _PSEUDOALIGN,
    "pseudoalign_anchor": _PSEUDOALIGN,
    "pseudoalign_anchor_wave2": _PSEUDOALIGN,
    "pseudoalign_long": _PSEUDOALIGN,
    "pseudoalign_halffail": _PSEUDOALIGN,
    "lookup_kmers": _PSEUDOALIGN,
    "lookup_kmers_packed": _PSEUDOALIGN,
    "compact_keys": _COMPACT,
    "gather_exemplars": _COMPACT,
    "gather_slim": _COMPACT,
    # --fmad=false: no a*b + c contraction, so the f64 EM is bitwise equal
    # to its plain version
    "em_step_batch": ("em.cu", ("--fmad=false",)),
}

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# kernel E (the C function compact_keys) counts as key_histogram, with
# per-read slots apart as key_histogram_slots; kernel H, B's epilogue, as
# bias_hexamers beside read_keys; kernel L on packed entries as lookup_kmers
LAUNCHES: Dict[str, int] = {
    name: 0 for name in (*(n for n in SOURCES if n not in (
                             "compact_keys", "lookup_kmers_packed")),
                         "pseudoalign_side_wave2", "pseudoalign_codes_wave2",
                         "key_histogram",
                         "key_histogram_slots", "bias_hexamers")}

_lock = threading.Lock()
_count_lock = threading.Lock()  # quant-tcc's shards launch from threads
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


class KeySide(ctypes.Structure):
    """One mate's SideResult pointers (struct KeySide in csrc/keys.cuh)."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "rows", "has", "ovf", "upos", "rpos", "block", "strand", "rng")] + [
        ("R", ctypes.c_int)]


class IndexView(ctypes.Structure):
    """The device index in either layout (struct IndexView in
    csrc/pseudoalign.cu): the bucketed tables (hkeys, bucket_start, ec)
    with S = 0, or the padded bucket rows with S > 0; N slots of
    payloads."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "hkeys", "bucket_start", "ec", "rows", "uid", "pos", "fw",
        "block")] + [("N", ctypes.c_longlong), ("p", ctypes.c_int),
                     ("S", ctypes.c_int)]


class EmArgs(ctypes.Structure):
    """Kernel G's tensors and sizes (struct EmArgs in csrc/em.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "bufs", "singleton", "inv_eff", "flat_tx", "ec_ptr", "multi",
        "tx_ptr", "tx_ec", "scale", "st", "changed")] + [
        (f, ctypes.c_int) for f in (
            "Bb", "T", "E", "batched_eff", "min_rounds")]


class BiasView(ctypes.Structure):
    """Kernel H's tables (struct BiasView in csrc/read_keys.cu)."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "block_start", "block_end", "useq_off", "useq")] + [
        ("S", ctypes.c_longlong)]


class KeyOpts(ctypes.Structure):
    """Kernel E's key options (struct KeyOpts in csrc/keys.cuh)."""

    _fields_ = [("pf_ptr", ctypes.c_void_p), ("pf_base", ctypes.c_void_p),
                ("NP", ctypes.c_longlong)] + [
        (f, ctypes.c_int) for f in (
            "k", "min_range", "strand_key", "pos_fl", "pos_depth")]


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIDE = ctypes.POINTER(KeySide)
_IX = ctypes.POINTER(IndexView)
_ARGTYPES = {
    "pseudoalign_side": [_IX, _P, _LL] + [_P] * 3 + [_I] * 7 + [_P] * 12
    + [_P],
    "pseudoalign_codes": [_IX, _P, _LL] + [_P] * 2 + [_I] * 7 + [_P] * 13
    + [_P],
    "pseudoalign_turbo": [_IX] + [_P] * 3 + [_LL, _P, _LL] + [_I] * 5
    + [_P] * 10 + [_P],
    "pseudoalign_anchor": [_IX, _P, _LL] + [_P] * 3 + [_LL, _LL] + [_I] * 7
    + [_P] * 12 + [_P],
    "pseudoalign_anchor_wave2": [_IX] + [_P] * 3 + [_LL, _LL] + [_I] * 5
    + [_P] * 12 + [_P],
    "pseudoalign_long": [_IX] + [_P] * 3 + [_LL] + [_I] * 5 + [_P, _P, _LL]
    + [_P] * 8 + [_P],
    "read_keys": [_SIDE, _SIDE, _LL, _I, _P, _P, ctypes.POINTER(BiasView),
                  _P, _P, _P],
    "pseudoalign_halffail": [_IX, _P, _LL] + [_P] * 4 + [_LL, _LL] + [_I] * 4
    + [_P] * 21 + [_P],
    "lookup_kmers": [_IX, _P, _P, _LL, _P, _P, _P, _P],
    "lookup_kmers_packed": [_IX, _P, _P, _P, _LL, _P, _P, _P, _P],
    "compact_keys": [_SIDE, _SIDE, ctypes.POINTER(KeyOpts), _P, _P, _LL, _LL,
                     _I, _I, _P, _LL, _P],
    "gather_slim": [_SIDE, _SIDE, _P, _LL, _LL, _P, _P],
    "gather_exemplars": [_SIDE, _SIDE, _P, _LL, _LL] + [_I] * 5 + [_P, _P],
    "em_step_batch": [_P, _P],
}


# the other C functions of a kernel's library: (kernel, function) ->
# (argtypes, restype)
_AUX: Dict[Tuple[str, str], Tuple[list, object]] = {
    ("em_step_batch", "em_graph_create"): (
        [ctypes.POINTER(EmArgs), _I, ctypes.POINTER(ctypes.c_void_p)],
        ctypes.c_int),
    ("em_step_batch", "em_graph_destroy"): ([_P], ctypes.c_int),
    ("pseudoalign_long", "pseudoalign_long_grid"): (
        [ctypes.POINTER(_I)], ctypes.c_int),
    ("compact_keys", "compact_keys_layout"): (
        [_LL, _LL, _I, _I, ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int),
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


def _lib_path(unit: Tuple[str, Tuple[str, ...]]) -> Tuple[str, list]:
    src, extra = unit
    src_path = os.path.join(CSRC, src)
    flags = list(_NVCC_FLAGS) + list(extra)
    h = hashlib.sha256()
    # the source and every header of csrc/ (csrc/keys.cuh is shared)
    for path in [src_path] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(src)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    return out, [src_path] + flags


def build_all() -> float:
    """Compile (in parallel) and load every kernel library not yet loaded.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = sorted({u for u in SOURCES.values() if u not in _libs})
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for unit in todo:
            out, args = _lib_path(unit)
            if os.path.exists(out):
                procs.append((unit, out, None, None))
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            p = subprocess.Popen(
                [_nvcc()] + args + ["-o", tmp],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            )
            procs.append((unit, out, tmp, p))
        errors = []
        for unit, out, tmp, p in procs:
            if p is None:
                continue
            so, se = p.communicate()
            log = (so + se).decode(errors="replace").strip()
            if p.returncode != 0:
                errors.append(f"nvcc failed for {unit[0]}:\n{log}")
                continue
            if log:
                print(f"[kernels] {unit[0]}: {log}", flush=True)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for unit, out, _, _ in procs:
            lib = ctypes.CDLL(out)
            for name, u in SOURCES.items():
                if u == unit:
                    fn = getattr(lib, name)
                    fn.argtypes = _ARGTYPES[name]
                    fn.restype = ctypes.c_int
            _libs[unit] = lib
    return time.perf_counter() - t0


def _fn(name: str):
    unit = SOURCES[name]
    if unit not in _libs:
        build_all()
    return getattr(_libs[unit], name)


def _aux_fn(kernel: str, name: str):
    """C function `name` of kernel `kernel`'s library (built at first
    use), with its argtypes from _AUX."""
    _fn(kernel)
    f = getattr(_libs[SOURCES[kernel]], name)
    f.argtypes, f.restype = _AUX[(kernel, name)]
    return f


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, dev: torch.device, *args,
            count: Union[str, Tuple[str, ...]] = "", n: int = 1) -> None:
    """Call kernel `name`'s C function with `args` and the current stream of
    `dev`, with `dev` made the current device: the libraries' CUDA runtime
    launches on the device current in the calling thread, so a kernel whose
    inputs lie on cuda:1 must not be launched from cuda:0.  Raises on a
    non-zero cudaError_t; counts n launches (a graph replay: the rounds it
    holds) under `count` (default `name`; a tuple: one C call that
    launches a kernel under each name).  When `dev` is already current the
    raw stream is read without the device switch (fewer host
    microseconds)."""
    fn = _fn(name)
    C = torch._C
    idx = dev.index
    if idx is not None and C._cuda_getDevice() == idx:
        err = fn(*args, C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    with _count_lock:
        for c in (count or name,) if isinstance(count, str) else count:
            LAUNCHES[c] += n


def _check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape, on
    device, where given).  The first test passes a good tensor with four
    reads; a tensor that fails it gets the refusal that names its fault."""
    try:
        if (t.dtype is dtype and t.is_cuda
                and (device is None or t.get_device() == device.index)
                and (shape is None or t.shape == shape)
                and t.is_contiguous()):
            return
    except AttributeError:
        pass
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
                     lens: torch.Tensor, k: int, L: int, R: int,
                     waves: int = 3, lists=None):
    """Kernel A on one mate's packed batch: wave 1 writes every read that
    its anchors verify in full and lists the others, wave 2 runs A's
    decode and the per-read core on the listed reads; two launches on one
    stream from one C call, the list's length read on the card.  Returns
    (the ten SideResult fields as a tuple of CUDA tensors -- rows, n_rows,
    has_hits, overflow, f_uid, f_block, f_upos, f_rpos, f_strand, rng --,
    fail_list [max(B, 1)] int32, n_fail [1] int64: the reads of wave 2).
    waves = 1 or 2 launches one wave alone (chip_smoke.py times them
    apart); wave 2 alone continues `lists`, what a wave-1 call returned.
    B = 0 launches nothing."""
    from .anchor import n_anchors_for

    dev = didx.device
    B = int(lens.shape[0])
    if L % 8 or L < k or not 0 < R <= L - k + 1:
        raise ValueError(f"bad shape: L={L} k={k} R={R} (L a multiple of 8)")
    if B >= 2**31:
        raise ValueError(f"{B} reads: kernel A takes fewer than 2^31")
    if waves not in (1, 2, 3) or (waves == 2) != (lists is not None):
        raise ValueError("waves 1 or 3, or 2 with the lists of wave 1")
    _check(packed, "packed", torch.uint8, (B, L // 4), dev)
    _check(nmask, "nmask", torch.uint8, (B, L // 8), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    be8 = didx.block_ec8
    _check(be8, "block_ec8", torch.int32, (be8.shape[0], 8), dev)
    ix = _index_args(didx)
    out, fail_list, n_fail = _lists(B, R, dev, lists)
    if B == 0:
        return out, fail_list, n_fail
    na = n_anchors_for(L, k)
    _launch(
        "pseudoalign_side", dev,
        ctypes.byref(ix), _ptr(be8), int(be8.numel()), _ptr(packed),
        _ptr(nmask), _ptr(lens), B, L, k, R, na, anchor_group_width(na),
        waves, *[_ptr(t) for t in out], _ptr(fail_list), _ptr(n_fail),
        count=(("pseudoalign_side",) if waves & 1 else ())
        + (("pseudoalign_side_wave2",) if waves & 2 else ()))
    return out, fail_list, n_fail


def _lists(B: int, R: int, dev, lists):
    """Kernel A's or A on codes' outputs and wave-2 list: new (the fields
    of B reads with R row slots, then one allocation for n_fail, 8-byte
    aligned, and the list of max(B, 1) ints), or wave 1's `lists` checked
    for wave 2 alone."""
    if lists is None:
        buf = torch.empty(2 + max(B, 1), dtype=torch.int32, device=dev)
        n_fail, fail_list = buf[:2].view(torch.int64), buf[2:]
        if B == 0:
            n_fail.zero_()
        return _side_outputs(B, R, dev), fail_list, n_fail
    out, fail_list, n_fail = lists
    _check(fail_list, "fail_list", torch.int32, (max(B, 1),), dev)
    _check(n_fail, "n_fail", torch.int64, (1,), dev)
    return out, fail_list, n_fail


def _probes(probes: Optional[torch.Tensor], dev):
    """The optional count of probed windows: a [1] int64 tensor on dev."""
    if probes is not None:
        _check(probes, "probes", torch.int64, (1,), dev)
    return _ptr(probes)


def pseudoalign_codes(didx, codes: torch.Tensor, lens: torch.Tensor, k: int,
                      R: int, waves: int = 3, lists=None,
                      probes: Optional[torch.Tensor] = None):
    """Kernel A on unpacked codes [B, L] uint8 (any L >= k; a code above 3
    is an N) with lens [B] int32, in two launches on one stream from one C
    call as pseudoalign_side: wave 1 writes every read that its anchors
    verify in full and lists the others, wave 2 runs the decode and the
    covered-interval core on the listed reads (the list's length read on
    the card).  Returns (the ten SideResult fields, fail_list [max(B, 1)]
    int32, n_fail [1] int64).  waves = 1 or 2 launches one wave alone
    (wave 2 continues `lists`, what a wave-1 call returned); probes, a [1]
    int64 tensor on the card, gains the windows wave 2 probed (counting
    costs an atomic a read, so only measurements ask).  B = 0 launches
    nothing."""
    from .anchor import n_anchors_for

    dev = didx.device
    if codes.dim() != 2:
        raise ValueError("codes must be [B, L]")
    B, L = int(codes.shape[0]), int(codes.shape[1])
    if L < k or not 0 < R <= L - k + 1:
        raise ValueError(f"bad shape: L={L} k={k} R={R}")
    if B >= 2**31:
        raise ValueError(f"{B} reads: kernel A takes fewer than 2^31")
    if waves not in (1, 2, 3) or (waves == 2) != (lists is not None):
        raise ValueError("waves 1 or 3, or 2 with the lists of wave 1")
    _check(codes, "codes", torch.uint8, (B, L), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    be8 = didx.block_ec8
    _check(be8, "block_ec8", torch.int32, (be8.shape[0], 8), dev)
    ix = _index_args(didx)
    pr = _probes(probes, dev)
    out, fail_list, n_fail = _lists(B, R, dev, lists)
    if B == 0:
        return out, fail_list, n_fail
    na = n_anchors_for(L, k)
    _launch(
        "pseudoalign_codes", dev,
        ctypes.byref(ix), _ptr(be8), int(be8.numel()), _ptr(codes),
        _ptr(lens), B, L, k, R, na, anchor_group_width(na), waves,
        *[_ptr(t) for t in out], _ptr(fail_list), _ptr(n_fail), pr,
        count=(("pseudoalign_codes",) if waves & 1 else ())
        + (("pseudoalign_codes_wave2",) if waves & 2 else ()))
    return out, fail_list, n_fail


def _index_args(didx) -> IndexView:
    """The checked IndexView of a device index in either layout (kernels
    A, D, I, J, K and L): a PaddedDeviceIndex passes its bucket rows and
    S, a DeviceIndex its sorted keys, bucket_start and kmer_ec."""
    dev = didx.device
    M = 1 << didx.p
    ix = IndexView(p=didx.p)
    if hasattr(didx, "bucket_rows"):
        S = int(didx.bucket_rows.shape[1]) // 2
        if S < 1 or S & (S - 1):
            raise ValueError(f"bucket_rows: width {2 * S}, expected 2S "
                             "with S a power of two")
        _check(didx.bucket_rows, "bucket_rows", torch.int64, (M, 2 * S), dev)
        ix.rows, ix.S, ix.N = _ptr(didx.bucket_rows), S, M * S
    else:
        N = int(didx.kmer_hkeys.shape[0])
        _check(didx.kmer_hkeys, "kmer_hkeys", torch.int64, (N,), dev)
        _check(didx.bucket_start, "bucket_start", torch.int32, (M + 1,), dev)
        _check(didx.kmer_ec, "kmer_ec", torch.int32, (N,), dev)
        ix.hkeys, ix.ec = _ptr(didx.kmer_hkeys), _ptr(didx.kmer_ec)
        ix.bucket_start, ix.S, ix.N = _ptr(didx.bucket_start), 0, N
    for nm in ("kmer_uid", "kmer_pos", "kmer_block"):
        _check(getattr(didx, nm), nm, torch.int32, (ix.N,), dev)
    _check(didx.kmer_fw, "kmer_fw", torch.bool, (ix.N,), dev)
    ix.uid, ix.pos = _ptr(didx.kmer_uid), _ptr(didx.kmer_pos)
    ix.fw, ix.block = _ptr(didx.kmer_fw), _ptr(didx.kmer_block)
    return ix


def _side_outputs(B: int, R: int, dev) -> tuple:
    """Empty SideResult fields for B reads with R row slots."""
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    return (
        torch.empty((B, R), **i32), torch.empty(B, **i32),
        torch.empty(B, **b8), torch.empty(B, **b8),
        torch.empty(B, **i32), torch.empty(B, **i32), torch.empty(B, **i32),
        torch.empty(B, **i32), torch.empty(B, **b8), torch.empty(B, **i32),
    )


# ---------------------------------------------------------------- kernel D


def pseudoalign_turbo(didx, sides, aux: torch.Tensor,
                      lens: Optional[torch.Tensor], k: int, L: int, rl: int,
                      R: int):
    """Kernel D on one or two mates' packed codes (`sides`, each [Bp, L/4]
    uint8) with the aux vector [4 + n] int64 (N positions ascending) and,
    for a mixed-length batch, lens [ns * Bp] uint16.  Returns the ten
    SideResult fields for the ns * Bp reads, mate 1 first."""
    dev = didx.device
    ns = len(sides)
    if ns not in (1, 2):
        raise ValueError("kernel D takes one or two mates")
    Bp = int(sides[0].shape[0])
    Lc = rl if 0 < rl < L else L
    if L % 4 or Lc < k or not 0 < R <= Lc - k + 1:
        raise ValueError(f"bad shape: L={L} rl={rl} k={k} R={R}")
    for j, p in enumerate(sides):
        _check(p, f"packed{j + 1}", torch.uint8, (Bp, L // 4), dev)
    if aux.dim() != 1 or aux.shape[0] < 4:
        raise ValueError("aux must be [4 + n] int64")
    _check(aux, "aux", torch.int64, None, dev)
    if lens is not None:
        _check(lens, "lens", torch.uint16, (ns * Bp,), dev)
    ix = _index_args(didx)
    out = _side_outputs(ns * Bp, R, dev)
    _launch(
        "pseudoalign_turbo", dev,
        ctypes.byref(ix), _ptr(sides[0]), _ptr(sides[1]) if ns == 2 else None, _ptr(aux),
        int(aux.shape[0]) - 4, _ptr(lens), Bp, ns, L, rl, k, R,
        *[_ptr(t) for t in out])
    return out


# ---------------------------------------------------------------- kernel I


def anchor_group_width(n_anchors: int) -> int:
    """Kernel I's wave-1 lanes per read: the smallest power of two >=
    n_anchors, at most 32 (a read of more anchors loops over its warp)."""
    g = 2
    while g < min(n_anchors, 32):
        g <<= 1
    return g


def _anchor_args(didx, sides, aux: torch.Tensor, k: int, L: int, rl: int,
                 R: int):
    """Kernel I's checked inputs shared by its two launches: (dev, ns, Bp,
    IndexView)."""
    dev = didx.device
    ns = len(sides)
    if ns not in (1, 2):
        raise ValueError("kernel I takes one or two mates")
    Bp = int(sides[0].shape[0])
    Lc = rl if 0 < rl < L else L
    Rc = min(R, Lc - k + 1)
    if L % 4 or Lc < k or R < 1 or Rc not in (1, R):
        raise ValueError(f"bad shape: L={L} rl={rl} k={k} R={R}")
    for j, p in enumerate(sides):
        _check(p, f"packed{j + 1}", torch.uint8, (Bp, L // 4), dev)
    if aux.dim() != 1 or aux.shape[0] < 4:
        raise ValueError("aux must be [4 + n] int64")
    _check(aux, "aux", torch.int64, None, dev)
    return dev, ns, Bp, _index_args(didx)


def anchor_wave1(didx, sides, aux: torch.Tensor, k: int, L: int, rl: int,
                 R: int, n_anchors: int):
    """Kernel I's wave 1 (pseudoalign_anchor) on one or two mates' packed
    codes (`sides`, each [Bp, L/4] uint8) with the aux vector [4 + n]
    int64: every verified and padding read written in full, every failing
    read listed.  Returns (the ten SideResult fields for the ns * Bp
    reads, mate 1 first; fail_list [ns * Bp] int32; n_fail [1] int64, the
    length of the list)."""
    dev, ns, Bp, ix = _anchor_args(didx, sides, aux, k, L, rl, R)
    if n_anchors < 2:
        raise ValueError(f"n_anchors={n_anchors}")
    be8 = didx.block_ec8
    _check(be8, "block_ec8", torch.int32, (be8.shape[0], 8), dev)
    out = _side_outputs(ns * Bp, R, dev)
    fail_list = torch.empty(max(ns * Bp, 1), dtype=torch.int32, device=dev)
    n_fail = torch.empty(1, dtype=torch.int64, device=dev)
    _launch(
        "pseudoalign_anchor", dev,
        ctypes.byref(ix), _ptr(be8), int(be8.numel()), _ptr(sides[0]),
        _ptr(sides[1]) if ns == 2 else None, _ptr(aux),
        int(aux.shape[0]) - 4, Bp, ns, L, rl, k, R, n_anchors,
        anchor_group_width(n_anchors), *[_ptr(t) for t in out],
        _ptr(fail_list), _ptr(n_fail))
    return out, fail_list, n_fail


def anchor_wave2(didx, sides, aux: torch.Tensor, k: int, L: int, rl: int,
                 R: int, out, fail_list: torch.Tensor,
                 n_fail: torch.Tensor) -> None:
    """Kernel I's wave 2 (pseudoalign_anchor_wave2): kernel D's decode and
    core on the reads that wave 1 listed, written into its outputs `out`."""
    dev, ns, Bp, ix = _anchor_args(didx, sides, aux, k, L, rl, R)
    _check(fail_list, "fail_list", torch.int32, (max(ns * Bp, 1),), dev)
    _check(n_fail, "n_fail", torch.int64, (1,), dev)
    _launch(
        "pseudoalign_anchor_wave2", dev,
        ctypes.byref(ix), _ptr(sides[0]),
        _ptr(sides[1]) if ns == 2 else None, _ptr(aux),
        int(aux.shape[0]) - 4, Bp, ns, L, rl, k, R, *[_ptr(t) for t in out],
        _ptr(fail_list), _ptr(n_fail))


def pseudoalign_anchor(didx, sides, aux: torch.Tensor, k: int, L: int,
                       rl: int, R: int, n_anchors: int):
    """Kernel I, the two-wave anchor kernel, on one or two mates' packed
    codes: wave 1, then wave 2 on the reads it listed, two launches on one
    stream.  R is the row width of every read (max_rows); the wave-2 core
    gives min(R, Lc - k + 1) rows, which must be R or 1 (a one-slot row
    fills every slot).  Returns the ten SideResult fields for the ns * Bp
    reads, mate 1 first, and n_fail ([1] int64, reads of wave 2)."""
    out, fail_list, n_fail = anchor_wave1(didx, sides, aux, k, L, rl, R,
                                          n_anchors)
    anchor_wave2(didx, sides, aux, k, L, rl, R, out, fail_list, n_fail)
    return out, n_fail


# ---------------------------------------------------------------- kernel K


def pseudoalign_halffail(didx, pkf: torch.Tensor, vsum: torch.Tensor,
                         sidev: torch.Tensor, aux: torch.Tensor, k: int,
                         L: int, rl: int, R: int,
                         probes: Optional[torch.Tensor] = None):
    """Kernel K on the pairs of which one mate failed host wave 1: pkf
    [Bp, L/4] uint8 the failed mates' packed codes, vsum [Bp, 2] int32 the
    verified mates' summaries, sidev [Bp] int32 (1: mate 1 failed), aux
    [4 + n] int64.  R is both mates' row width, min(max_rows, Lc - k + 1).
    probes, a [1] int64 tensor on the card, gains the failed mates'
    windows that the covered-interval core probed (a warp reduction and an
    atomic a warp, so only measurements ask).  Returns mate 1's and mate
    2's ten SideResult fields."""
    dev = didx.device
    Bp = int(pkf.shape[0])
    Lc = rl if 0 < rl < L else L
    if L % 4 or Lc < k or not 0 < R <= Lc - k + 1:
        raise ValueError(f"bad shape: L={L} rl={rl} k={k} R={R}")
    _check(pkf, "pkf", torch.uint8, (Bp, L // 4), dev)
    _check(vsum, "vsum", torch.int32, (Bp, 2), dev)
    _check(sidev, "sidev", torch.int32, (Bp,), dev)
    if aux.dim() != 1 or aux.shape[0] < 4:
        raise ValueError("aux must be [4 + n] int64")
    _check(aux, "aux", torch.int64, None, dev)
    be8 = didx.block_ec8
    _check(be8, "block_ec8", torch.int32, (be8.shape[0], 8), dev)
    ix = _index_args(didx)
    pr = _probes(probes, dev)
    out1 = _side_outputs(Bp, R, dev)
    out2 = _side_outputs(Bp, R, dev)
    _launch(
        "pseudoalign_halffail", dev,
        ctypes.byref(ix), _ptr(be8), int(be8.numel()), _ptr(pkf), _ptr(vsum), _ptr(sidev),
        _ptr(aux), int(aux.shape[0]) - 4, Bp, L, rl, k, R,
        *[_ptr(t) for t in out1], *[_ptr(t) for t in out2], pr)
    return out1, out2


# ---------------------------------------------------------------- kernel J

_long_grids: Dict[int, int] = {}


def long_plan(L: int, k: int) -> Tuple[int, int]:
    """Kernel J's row-list plan at padded width L: (cap, spill).  cap is
    the power of two >= W = L - k + 1, the most openers a read can list,
    padded for the sort; spill is the ints of global row list each block
    needs (cap once cap passes LONG_SLIST, the shared list, else 0)."""
    W = L - k + 1
    cap = 1
    while cap < W:
        cap <<= 1
    return cap, (cap if cap > LONG_SLIST else 0)


def _long_grid(dev) -> int:
    """Kernel J's persistent grid on `dev`: SMs x the blocks one SM holds
    (the occupancy of the built kernel, asked of the library once)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _long_grids:
        n = ctypes.c_int()
        with torch.cuda.device(dev):
            err = _aux_fn("pseudoalign_long", "pseudoalign_long_grid")(
                ctypes.byref(n))
        _raise_on(err, "pseudoalign_long (grid)")
        _long_grids[key] = int(n.value)
    return _long_grids[key]


def pseudoalign_long(didx, packed: torch.Tensor, nmask: torch.Tensor,
                     lens: torch.Tensor, k: int, L: int, R: int, G: int):
    """Kernel J on one packed batch of long reads.  Returns the eight
    LongResult fields as a tuple of CUDA tensors (rows [B, R], n_rows,
    has_hits, overflow, unmapped, groups [B, G], n_groups, g_overflow)."""
    dev = didx.device
    B = int(lens.shape[0])
    W = L - k + 1
    if L % 8 or L < k or not 0 < R <= W or G < 1:
        raise ValueError(f"bad shape: L={L} k={k} R={R} G={G}")
    _check(packed, "packed", torch.uint8, (B, L // 4), dev)
    _check(nmask, "nmask", torch.uint8, (B, L // 8), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    ix = _index_args(didx)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    out = (torch.empty((B, R), **i32), torch.empty(B, **i32),
           torch.empty(B, **b8), torch.empty(B, **b8), torch.empty(B, **i32),
           torch.empty((B, G), **i32), torch.empty(B, **i32),
           torch.empty(B, **b8))
    if B == 0:
        return out
    grid = min(B, _long_grid(dev))
    cap, spill_n = long_plan(L, k)
    spill = torch.empty(grid * spill_n, **i32) if spill_n else None
    next_read = torch.zeros(1, **i32)
    _launch(
        "pseudoalign_long", dev,
        ctypes.byref(ix), _ptr(packed), _ptr(nmask), _ptr(lens), B, L, k, R,
        G, grid, _ptr(next_read), _ptr(spill), cap, *[_ptr(t) for t in out])
    return out


# ---------------------------------------------------------------- kernel L


def lookup_kmers(didx, canon: torch.Tensor, valid: torch.Tensor):
    """Kernel L, K2's probe alone: (slot int64, hit bool, EC row int32) of
    each canonical k-mer of `canon` (int64, any shape) under `valid` (bool,
    same shape), in either index layout; equal to the plain lookup_kmers
    of ops/pseudoalign.py.  A bucketed index is probed through its packed
    (key, EC row) entries (packed_entries), a padded one through its bucket
    rows.  No run loop calls it."""
    dev = didx.device
    shape = tuple(canon.shape)
    _check(canon, "canon", torch.int64, shape, dev)
    _check(valid, "valid", torch.bool, shape, dev)
    ix = _index_args(didx)
    idx = torch.empty(shape, dtype=torch.int64, device=dev)
    hit = torch.empty(shape, dtype=torch.bool, device=dev)
    ec = torch.empty(shape, dtype=torch.int32, device=dev)
    if canon.numel() == 0:
        return idx, hit, ec
    if not ix.S:
        ent = packed_entries(didx)
        _launch("lookup_kmers_packed", dev, ctypes.byref(ix), _ptr(ent),
                _ptr(canon), _ptr(valid), canon.numel(), _ptr(idx),
                _ptr(hit), _ptr(ec), count="lookup_kmers")
    else:
        _launch("lookup_kmers", dev, ctypes.byref(ix), _ptr(canon),
                _ptr(valid), canon.numel(), _ptr(idx), _ptr(hit), _ptr(ec))
    return idx, hit, ec


# kernel L's packed entries, one array per bucketed DeviceIndex: (its key
# table's and EC table's data pointers, device) -> (weak references to both
# tables, [N, 2] int64); an entry goes when either table is freed
_ENTRIES: Dict[tuple, tuple] = {}


def packed_entries(didx) -> torch.Tensor:
    """The [N, 2] int64 (mixed key, EC row) entries of a bucketed
    DeviceIndex in slot order (ops/pseudoalign.py packed_entries_plain),
    16 bytes a k-mer, built on the index's device at the first call and
    kept while its key and EC tables live (an index that shares the key
    table with another but has its own EC table gets its own entries)."""
    keys, ecs = didx.kmer_hkeys, didx.kmer_ec
    key = (keys.data_ptr(), ecs.data_ptr(), keys.device.index)
    hit = _ENTRIES.get(key)
    if hit is not None and hit[0]() is keys and hit[1]() is ecs:
        return hit[2]
    from .pseudoalign import packed_entries_plain

    ent = packed_entries_plain(didx)
    _ENTRIES[key] = (weakref.ref(keys), weakref.ref(ecs), ent)
    for t in (keys, ecs):
        weakref.finalize(t, _ENTRIES.pop, key, None)
    return ent


# ---------------------------------------------------------------- kernel B

# a mate's SideResult fields in struct KeySide's order: (name, dtype)
_KEY_FIELDS = (("rows", torch.int32), ("has_hits", torch.bool),
               ("overflow", torch.bool), ("f_upos", torch.int32),
               ("f_rpos", torch.int32), ("f_block", torch.int32),
               ("f_strand", torch.bool), ("rng", torch.int32))


def _key_side(s, name: str, dev, B: int, with_fields: bool) -> KeySide:
    """Checked KeySide of one mate; the first-hit fields and rng are
    passed only when the kernel reads them."""
    rows = s.rows
    shape = (B, int(rows.shape[1]) if rows.dim() == 2 else -1)
    ptrs = []
    for nm, dtype in _KEY_FIELDS if with_fields else _KEY_FIELDS[:3]:
        t = getattr(s, nm)
        _check(t, nm + name, dtype, shape, dev)
        ptrs.append(t.data_ptr())
        shape = (B,)
    return KeySide(*ptrs, *(None,) * (8 - len(ptrs)), rows.shape[1])


def read_keys(s1, s2, k: int, bias=None):
    """Kernel B, the per-read form: (h [B, 2] int64, tl [B] int32 or None,
    hx [B] int32 or None).  h is the key with every option off; tl the
    mapPair fragment length (paired only); with bias (a BiasTables on the
    card) hx is kernel H, each read's 5' hexamer id from mate 1 (valid:
    mate 2's has_hits, every single-end read), computed by the same
    launch.  The three in one allocation.  B = 0 launches nothing; a
    launch counts as read_keys, and with bias as bias_hexamers too."""
    dev = s1.rows.device
    B = int(s1.rows.shape[0])
    paired = s2 is not None
    ks1 = _key_side(s1, "1", dev, B, paired or bias is not None)
    ks2 = _key_side(s2, "2", dev, B, True) if paired else None
    n_tl = (B + 1) // 2 if paired else 0
    if bias is None:
        # bias off: B alone, no hexamer slot and no tables
        buf = torch.empty(2 * B + n_tl, dtype=torch.int64, device=dev)
        h = buf.as_strided((B, 2), (2, 1))
        tl = buf.view(torch.int32).as_strided((B,), (1,), 4 * B) \
            if paired else None
        if B:
            _launch("read_keys", dev, ctypes.byref(ks1),
                    ctypes.byref(ks2) if paired else None, B, k, _ptr(h),
                    _ptr(tl), None, None, None)
        return h, tl, None
    bv = _bias_view(bias, dev)
    _check(s1.f_uid, "f_uid1", torch.int32, (B,), dev)
    buf = torch.empty(2 * B + n_tl + (B + 1) // 2, dtype=torch.int64,
                      device=dev)
    h = buf.as_strided((B, 2), (2, 1))
    w32 = buf.view(torch.int32)
    tl = w32.as_strided((B,), (1,), 4 * B) if paired else None
    hx = w32.as_strided((B,), (1,), 4 * B + 2 * n_tl)
    if B:
        _launch("read_keys", dev, ctypes.byref(ks1),
                ctypes.byref(ks2) if paired else None, B, k, _ptr(h),
                _ptr(tl), ctypes.byref(bv), _ptr(s1.f_uid), _ptr(hx),
                count=("read_keys", "bias_hexamers"))
    return h, tl, hx


# kernel H's checked tables, one per BiasTables: (data pointers, device)
# -> (BiasView, weak references to the tables, the padded copy of
# unitig_seq or None)
_BIAS_VIEWS: Dict[tuple, tuple] = {}


def _bias_view(bt, dev) -> BiasView:
    """The checked BiasView of a BiasTables on dev, built once per tables
    (keyed by their data pointers and device, the tables held by weak
    reference, so that a freed table's pointer names no stale view).
    The kernel reads unitig_seq as aligned 8-byte words, so its storage
    must reach the next multiple of 8 bytes past the S bases
    (bias_tables_from_host pads it so); tables that do not are copied
    once into a padded buffer."""
    ts = (bt.block_start, bt.block_end, bt.useq_off, bt.useq)
    key = (*(t.data_ptr() for t in ts), dev.index)
    hit = _BIAS_VIEWS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[1], ts)):
        return hit[0]
    NB = int(bt.block_start.shape[0])
    _check(bt.block_start, "block_start", torch.int32, (NB,), dev)
    _check(bt.block_end, "block_end", torch.int32, (NB,), dev)
    _check(bt.useq_off, "useq_off", torch.int64, None, dev)
    _check(bt.useq, "useq", torch.uint8, None, dev)
    S = int(bt.useq.shape[0])
    if S < 6:
        raise ValueError("unitig sequences shorter than one hexamer")
    useq = bt.useq
    room = useq.untyped_storage().nbytes() - useq.storage_offset()
    if useq.data_ptr() % 8 or room < -(-S // 8) * 8:
        useq = torch.zeros(-(-S // 8) * 8, dtype=torch.uint8, device=dev)
        useq[:S] = bt.useq
    bv = BiasView(_ptr(bt.block_start), _ptr(bt.block_end),
                  _ptr(bt.useq_off), _ptr(useq), S)
    for kk in [kk for kk, v in _BIAS_VIEWS.items()
               if any(r() is None for r in v[1])]:
        del _BIAS_VIEWS[kk]
    _BIAS_VIEWS[key] = (bv, tuple(weakref.ref(t) for t in ts),
                        useq if useq is not bt.useq else None)
    return bv


# ---------------------------------------------------------------- kernel E

@functools.lru_cache(maxsize=64)
def _ck_layout(B: int, K: int, with_slots: bool, want_keys: bool):
    """Kernel E's one allocation, in 8-byte words, from its C library
    (csrc/compact.cu ke_layout): (h offset, slots offset, flags offset,
    total)."""
    out = (ctypes.c_longlong * 4)()
    _raise_on(_aux_fn("compact_keys", "compact_keys_layout")(
        B, K, int(with_slots), int(want_keys), out), "compact_keys_layout")
    return tuple(out)


def compact_keys(s1, s2, spec, K: int, with_slots: bool = False, didx=None,
                 keys=None, want_keys: bool = False):
    """Kernel E: the steady state's key step in one C call -- each read's
    compact key (kernel B's key function under spec, a KeySpec; didx
    carries the position tables when spec.pos_key) fused into the flat
    [K+1, 5] int64 key table (ops/pseudoalign.py key_histogram_plain for
    the layout); with_slots also each read's row in it ([B] int32).
    keys = (h [B, 2] int64, flags [B] int32) gives the keys instead of
    s1 and s2 (the tests' crafted keys).  Returns (ck, slots or None, h,
    flags): views of one allocation; with want_keys h [B, 2] and flags [B]
    are the keys the table was built from, else None.  Counted as
    key_histogram (key_histogram_slots with slots); B = 0 launches
    nothing."""
    if K < 1:
        raise ValueError("K must be >= 1")
    ks1 = ks2 = opts = None
    hin = fin = None
    if keys is not None:
        hin, fin = keys
        dev = hin.device
        B = int(hin.shape[0])
        _check(hin, "h", torch.int64, (B, 2), dev)
        _check(fin, "flags", torch.int32, (B,), dev)
    else:
        dev = s1.rows.device
        B = int(s1.rows.shape[0])
        fields = (s2 is not None or spec.min_range > 1 or spec.strand_key
                  or spec.pos_key)
        ks1 = _key_side(s1, "1", dev, B, fields)
        ks2 = _key_side(s2, "2", dev, B, True) if s2 is not None else None
        opts = KeyOpts(None, None, 0, spec.k, spec.min_range,
                       int(bool(spec.strand_key)), -1, 0)
        if spec.pos_key:
            if didx is None or didx.pf_ptr is None:
                raise ValueError(
                    "the position key column needs didx with pos tables")
            _check(didx.pf_ptr, "pf_ptr", torch.int32, None, dev)
            _check(didx.pf_base, "pf_base", torch.int32, None, dev)
            opts.pf_ptr, opts.pf_base = _ptr(didx.pf_ptr), _ptr(didx.pf_base)
            opts.NP = int(didx.pf_base.shape[0]) // 2
            opts.pos_fl, opts.pos_depth = int(spec.pos_fl), int(spec.pos_depth)
    if B >= 2**30:
        raise ValueError(f"{B} reads: kernel E takes fewer than 2^30")
    o_h, o_sl, o_fl, n = _ck_layout(B, K, with_slots, want_keys)
    ws = torch.empty(n, dtype=torch.int64, device=dev)
    ck = ws.as_strided((K + 1, 5), (5, 1))
    slots = h = flags = None
    if with_slots or want_keys:
        w32 = ws.view(torch.int32)
        if with_slots:
            slots = w32.as_strided((B,), (1,), 2 * o_sl)
        if want_keys:
            h = ws.as_strided((B, 2), (2, 1), o_h)
            flags = w32.as_strided((B,), (1,), 2 * o_fl)
    if B == 0:
        ck.zero_()
        return ck, slots, h, flags
    _launch(
        "compact_keys", dev,
        ctypes.byref(ks1) if ks1 is not None else None,
        ctypes.byref(ks2) if ks2 is not None else None,
        ctypes.byref(opts) if opts is not None else None,
        _ptr(hin), _ptr(fin), B, K, int(with_slots), int(want_keys),
        _ptr(ws), n,
        count="key_histogram_slots" if with_slots else "key_histogram")
    return ck, slots, h, flags


# ---------------------------------------------------------------- kernel F


def gather_exemplars(idx: torch.Tensor, s1, s2, spec) -> torch.Tensor:
    """Kernel F: int32 key rows [n, W] of reads `idx` (int64 [n], any row
    of the SideResult) in the layout of ops/pseudoalign.py
    gather_exemplars_plain; spec is its KeySpec."""
    dev = s1.rows.device
    B = int(s1.rows.shape[0])
    n = int(idx.shape[0])
    _check(idx, "idx", torch.int64, (n,), dev)
    ks1 = _key_side(s1, "1", dev, B, True)
    ks2 = _key_side(s2, "2", dev, B, True) if s2 is not None else None
    ns = 1 if s2 is None else 2
    tail_bs = bool(spec.strand_key or spec.pos_key)
    W = (ks1.R + (ks2.R if ks2 is not None else 0) + 1
         + (2 * ns if tail_bs else 0) + (2 * ns if spec.pos_key else 0))
    out = torch.empty((n, W), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _launch(
        "gather_exemplars", dev,
        ctypes.byref(ks1), ctypes.byref(ks2) if ks2 is not None else None,
        _ptr(idx), n, B, spec.k, spec.min_range, int(tail_bs),
        int(spec.pos_key), W, _ptr(out))
    return out


def gather_slim(idx: torch.Tensor, s1, s2) -> torch.Tensor:
    """Kernel F's slim layout: [n, 5] int32 rows (rows1[0], rows1[1],
    rows2[0], rows2[1], flags) of the pair reads `idx` (int64 [n]); see
    ops/pseudoalign.py gather_slim_plain."""
    dev = s1.rows.device
    B = int(s1.rows.shape[0])
    n = int(idx.shape[0])
    _check(idx, "idx", torch.int64, (n,), dev)
    ks1 = _key_side(s1, "1", dev, B, False)
    ks2 = _key_side(s2, "2", dev, B, False)
    if ks1.R < 2 or ks2.R < 2:
        raise ValueError("the slim layout needs two row slots per mate")
    out = torch.empty((n, 5), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _launch("gather_slim", dev, ctypes.byref(ks1), ctypes.byref(ks2),
            _ptr(idx), n, B, _ptr(out))
    return out


# ---------------------------------------------------------------- kernel G


def em_layout(prob) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel G's replicate-minor rows of a DeviceEmProblem: singletons
    [T, Bb], multi counts [E, Bb] and inv_eff ([T] shared, the problem's
    own tensor, or [T, Bb]) -- the transposes of its [Bb, item] rows."""
    inv = prob.inv_eff
    return (prob.singleton_alpha.t().contiguous(),
            prob.multi_counts.t().contiguous(),
            inv.t().contiguous() if inv.dim() == 2 else inv)


class EmGraph:
    """`rounds` rounds of kernel G's loop captured once into a CUDA graph
    (csrc/em.cu em_graph_create: a private stream in thread-local capture
    mode, so that several threads may capture at once) and replayed by
    launch() on the device's current stream, each replay counted as
    `rounds` launches.  The loop's state: bufs [2, T, Bb] f64 (alpha,
    ping-pong), st [4 + 3 Bb] int64 (i, bound, running, 0, mode[Bb],
    done_at[Bb], last[Bb]) and changed [Bb] int32.  A round past the
    state's bound, or after every replicate froze, does nothing and does
    not advance i, so the rounds that ran are read back from the state.

    `prob` is a DeviceEmProblem with [Bb, T] singletons, [Bb, E] counts
    and [T] or [Bb, T] inv_eff; its tensors are checked once, here, and
    its replicate-minor rows (em_layout) made once.  A shared inv_eff is
    passed as the problem's own tensor, so the loop may rewrite it in
    place between bias segments.  Launches on the problem's own device:
    cells split across cards bind one problem per card.  A failed capture
    or launch raises."""

    def __init__(self, prob, bufs: torch.Tensor, st: torch.Tensor,
                 changed: torch.Tensor, min_rounds: int, rounds: int):
        dev = prob.flat_tx.device
        T, E = prob.num_trans, prob.num_multi
        M = int(prob.flat_tx.shape[0])
        if prob.singleton_alpha.dim() != 2:
            raise ValueError("singleton_alpha must be [Bb, T]")
        Bb = int(prob.singleton_alpha.shape[0])
        _check(prob.singleton_alpha, "singleton_alpha", torch.float64,
               (Bb, T), dev)
        _check(prob.multi_counts, "multi_counts", torch.float64, (Bb, E), dev)
        batched_eff = prob.inv_eff.dim() == 2
        _check(prob.inv_eff, "inv_eff", torch.float64,
               (Bb, T) if batched_eff else (T,), dev)
        _check(prob.flat_tx, "flat_tx", torch.int32, (M,), dev)
        _check(prob.ec_ptr, "ec_ptr", torch.int64, (E + 1,), dev)
        _check(prob.tx_ptr, "tx_ptr", torch.int64, (T + 1,), dev)
        _check(prob.tx_ec, "tx_ec", torch.int32, (M,), dev)
        _check(bufs, "bufs", torch.float64, (2, T, Bb), dev)
        _check(st, "st", torch.int64, (4 + 3 * Bb,), dev)
        _check(changed, "changed", torch.int32, (Bb,), dev)
        self.dev, self.rounds = dev, int(rounds)
        self.lay = em_layout(prob)
        self.scale = torch.empty(max(E * Bb, 1), dtype=torch.float64,
                                 device=dev)
        self._keep = (prob, bufs, st, changed)
        sing, multi, inv = self.lay
        self.args = EmArgs(
            bufs=_ptr(bufs), singleton=_ptr(sing), inv_eff=_ptr(inv),
            flat_tx=_ptr(prob.flat_tx), ec_ptr=_ptr(prob.ec_ptr),
            multi=_ptr(multi), tx_ptr=_ptr(prob.tx_ptr),
            tx_ec=_ptr(prob.tx_ec), scale=_ptr(self.scale), st=_ptr(st),
            changed=_ptr(changed), Bb=Bb, T=T, E=E,
            batched_eff=int(batched_eff), min_rounds=int(min_rounds))
        self.exec = ctypes.c_void_p()
        with torch.cuda.device(dev):
            err = _aux_fn("em_step_batch", "em_graph_create")(
                ctypes.byref(self.args), self.rounds, ctypes.byref(self.exec))
        _raise_on(err, "em_step_batch (graph capture)")

    def launch(self) -> None:
        _launch("em_step_batch", self.dev, self.exec, n=self.rounds)

    def close(self) -> None:
        if self.exec:
            with torch.cuda.device(self.dev):
                err = _aux_fn("em_step_batch", "em_graph_destroy")(self.exec)
            self.exec = ctypes.c_void_p()
            _raise_on(err, "em_step_batch (graph destroy)")
