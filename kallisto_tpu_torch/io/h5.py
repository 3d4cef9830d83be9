"""abundance.h5 writer + h5dump converter (reference: src/H5Writer.{h,cpp},
src/h5utils.{h,cpp}).  Gated on h5py availability: without h5py, quant
writes no abundance.h5.  h5dump is not a subcommand of the port's CLI
yet."""

import os
from typing import Optional, Sequence

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except ImportError:  # pragma: no cover
    HAVE_H5PY = False


def write_abundance_h5(
    path: str,
    est_counts: np.ndarray,
    target_names: Sequence[str],
    lengths: np.ndarray,
    eff_lens: np.ndarray,
    fld: np.ndarray,
    bias_observed: np.ndarray,
    bias_normalized: np.ndarray,
    num_bootstrap: int,
    num_processed: int,
    kallisto_version: str,
    index_version: int,
    start_time: str,
    call: str,
    bootstraps: Optional[np.ndarray] = None,  # [B, T]
    compression: int = 6,
) -> None:
    """Layout mirrors H5Writer::init/write_main/write_bootstrap
    (src/H5Writer.cpp:4-69)."""
    if not HAVE_H5PY:
        raise RuntimeError("h5py not available; use --plaintext")
    opts = dict(compression="gzip", compression_opts=compression)
    with h5py.File(path, "w") as f:
        f.create_dataset("est_counts", data=est_counts.astype(np.float64), **opts)
        aux = f.create_group("aux")
        s = h5py.string_dtype()
        aux.create_dataset("num_bootstrap", data=np.array([num_bootstrap], np.int32))
        aux.create_dataset("num_processed", data=np.array([num_processed], np.int32))
        aux.create_dataset("fld", data=fld.astype(np.int32), **opts)
        aux.create_dataset("bias_observed", data=bias_observed.astype(np.int32), **opts)
        aux.create_dataset(
            "bias_normalized", data=bias_normalized.astype(np.float64), **opts
        )
        aux.create_dataset("kallisto_version", data=np.array([kallisto_version], s))
        aux.create_dataset("index_version", data=np.array([index_version], np.int32))
        aux.create_dataset("call", data=np.array([call], s))
        aux.create_dataset("start_time", data=np.array([start_time], s))
        aux.create_dataset("ids", data=np.array(list(target_names), s), **opts)
        aux.create_dataset("eff_lengths", data=eff_lens.astype(np.float64), **opts)
        aux.create_dataset("lengths", data=lengths.astype(np.int32), **opts)
        if num_bootstrap > 0 and bootstraps is not None:
            bs = f.create_group("bootstrap")
            for b in range(bootstraps.shape[0]):
                bs.create_dataset(
                    f"bs{b}", data=bootstraps[b].astype(np.float64), **opts
                )


def h5dump(h5_path: str, out_dir: str) -> None:
    """Reverse path: abundance.h5 -> plaintext (reference: H5Converter,
    src/H5Writer.cpp:73-206)."""
    if not HAVE_H5PY:
        raise RuntimeError("h5py not available")
    from .writers import write_abundance_tsv, write_run_info
    from ..quant.em import counts_to_tpm

    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(h5_path, "r") as f:
        est = f["est_counts"][:]
        aux = f["aux"]
        names = [x.decode() if isinstance(x, bytes) else x for x in aux["ids"][:]]
        lens = aux["lengths"][:]
        eff = aux["eff_lengths"][:]
        nb = int(aux["num_bootstrap"][0])
        nproc = int(aux["num_processed"][0])
        version = aux["kallisto_version"][0]
        version = version.decode() if isinstance(version, bytes) else version
        idx_v = int(aux["index_version"][0])
        call = aux["call"][0]
        call = call.decode() if isinstance(call, bytes) else call
        stime = aux["start_time"][0]
        stime = stime.decode() if isinstance(stime, bytes) else stime

        write_abundance_tsv(
            os.path.join(out_dir, "abundance.tsv"),
            names, lens, eff, est, counts_to_tpm(est, eff),
        )
        write_run_info(
            os.path.join(out_dir, "run_info.json"),
            n_targets=len(names), n_bootstraps=nb, n_processed=nproc,
            n_pseudoaligned=0, n_unique=0,
            kallisto_version=version, index_version=idx_v, k=0,
            start_time=stime, call=call,
        )
        if nb > 0:
            for b in range(nb):
                alpha = f[f"bootstrap/bs{b}"][:]
                write_abundance_tsv(
                    os.path.join(out_dir, f"bs_abundance_{b}.tsv"),
                    names, lens, eff, alpha, counts_to_tpm(alpha, eff),
                )
