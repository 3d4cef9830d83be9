"""Versioned flat on-disk index format (npz container).

Encodes the same semantic content as the reference's binary index v13
(reference: src/KmerIndex.cpp:1170-1328 write, 1330-1559 load) -- canonical
k-mer table, unitigs, mosaic EC blocks, targets, D-list, on-list -- in a
dense numpy layout that loads straight into device arrays.
"""

import json

import numpy as np

from .build import TpuIndex
from ..common import INDEX_FORMAT_VERSION

_ARRAY_FIELDS = [
    "target_lens",
    "kmer_keys", "kmer_uid", "kmer_pos", "kmer_fw", "kmer_block",
    "block_uid", "block_start", "block_end", "block_ec",
    "ec_ptr", "ec_tx", "bp_ptr", "bp_tx", "bp_pos", "bp_rstart", "bp_rstop",
    "bp_strand",
    "unitig_nkmers", "unitig_seq_off", "unitig_seq",
    "target_seq_off", "target_seq",
    "dlist_keys",
]


def save_index(index: TpuIndex, path: str) -> None:
    meta = {
        "format_version": INDEX_FORMAT_VERSION,
        "k": index.k,
        "num_onlist": index.num_onlist,
        "aa": index.aa,
        "target_names": index.target_names,
    }
    arrays = {f: getattr(index, f) for f in _ARRAY_FIELDS}
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def index_from_numpy(arrays: dict) -> TpuIndex:
    """TpuIndex from a mapping of its arrays plus the metadata fields
    (k, target_names, num_onlist; aa and format_version optional) -- e.g.
    the fields of an index built by the JAX package, or an opened .npz
    (whose `_meta` entry then supplies the metadata)."""
    if "_meta" in arrays:
        meta = json.loads(bytes(np.asarray(arrays["_meta"])).decode())
    else:
        meta = {key: arrays[key] for key in ("k", "target_names", "num_onlist")}
        meta["aa"] = arrays.get("aa", False)
        meta["format_version"] = arrays.get(
            "format_version", INDEX_FORMAT_VERSION)
    if meta["format_version"] != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"incompatible index format version {meta['format_version']} "
            f"(expected {INDEX_FORMAT_VERSION}); rebuild the index"
        )
    return TpuIndex(
        k=int(meta["k"]),
        target_names=list(meta["target_names"]),
        num_onlist=int(meta["num_onlist"]),
        aa=bool(meta.get("aa", False)),
        format_version=meta["format_version"],
        **{f: np.asarray(arrays[f]) for f in _ARRAY_FIELDS},
    )


def load_index(path: str) -> TpuIndex:
    with np.load(path, allow_pickle=False) as z:
        return index_from_numpy({f: z[f] for f in list(_ARRAY_FIELDS) + ["_meta"]})
