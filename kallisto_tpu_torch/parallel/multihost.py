"""Multi-host data parallelism over torch.distributed: per-process file
shards and a deterministic cross-process EC merge.

Port of kallisto_tpu/parallel/multihost.py.  The reference's merge point
is a writer-locked map update (MasterProcessor::update,
src/ProcessReads.cpp:424-646) over pthreads on one node.  Here:

- the caller starts one process per card (or per host), initializes
  torch.distributed (`init_process_group` with its address, world size
  and rank) and passes run_quant its device (`cuda:<local rank>`);
- input files (pairs stay together) are assigned to ranks CONTIGUOUSLY
  in command-line order, so the global read order is rank 0's reads,
  then rank 1's, ... -- the order one process would see;
- every rank pseudoaligns its shard alone and ends with a local
  (transcript set -> count) map whose EC ids are first-seen in ITS read
  order;
- the maps are allgathered and merged ON EVERY RANK in rank order, which
  gives the one-process EC numbering, counts and est_counts; the FLD
  subsample prefixes merge in rank order and the processed count and
  the bias hexamers are summed;
- everything after the merge (EM, outputs) is replicated; rank 0 writes.

What crosses processes is host numpy (EC maps, FLD prefixes, sums), so
the collectives run on a gloo group on every platform: NCCL would only
stage the bytes through the card.
"""

import pickle
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

_gloo: dict = {}


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialized torch.distributed group;
    (0, 1) when none is."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_files(files: List[str], paired: bool, process_id: int,
                num_processes: int) -> List[str]:
    """Contiguous per-process assignment of files (pairs stay together)."""
    step = 2 if paired else 1
    units = [files[i : i + step] for i in range(0, len(files), step)]
    per = -(-len(units) // num_processes)
    mine = units[process_id * per : (process_id + 1) * per]
    return [f for u in mine for f in u]


def _host_group():
    """A gloo group over every rank: the default group when it is gloo,
    else one made once per process (every rank makes it in the same
    order, at its first merge)."""
    if dist.get_backend() == "gloo":
        return None
    if "g" not in _gloo:
        _gloo["g"] = dist.new_group(backend="gloo")
    return _gloo["g"]


def allgather_int64(vec: np.ndarray) -> np.ndarray:
    """[world, n] int64: every rank's n-vector, in rank order (n must be
    the same on every rank)."""
    t = torch.from_numpy(np.ascontiguousarray(vec, np.int64).reshape(-1))
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t, group=_host_group())
    return torch.stack(outs).numpy()


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's byte string, in rank order."""
    lens = allgather_int64(np.array([len(payload)]))[:, 0]
    m = max(int(lens.max()), 1)
    pad = np.zeros(m, np.uint8)
    pad[: len(payload)] = np.frombuffer(payload, np.uint8)
    t = torch.from_numpy(pad)
    outs = [torch.empty_like(t) for _ in range(lens.shape[0])]
    dist.all_gather(outs, t, group=_host_group())
    return [bytes(o[: int(n)].numpy()) for o, n in zip(outs, lens)]


def merge_host_ec_maps(
    ec_sets: List[np.ndarray], counts: np.ndarray
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Allgather every rank's (set, count) map and merge in rank order.

    Returns the merged (ec_sets, counts), identical on every rank and
    equal to a one-process run over the concatenated inputs."""
    local = [(s.astype(np.int32), int(c)) for s, c in zip(ec_sets, counts)]
    merged: dict = {}
    order: List[np.ndarray] = []
    out_counts: List[int] = []
    for blob in allgather_bytes(pickle.dumps(local)):
        for s, c in pickle.loads(blob):
            kb = s.tobytes()
            ec = merged.get(kb)
            if ec is None:
                ec = len(order)
                merged[kb] = ec
                order.append(s)
                out_counts.append(0)
            out_counts[ec] += c
    return order, np.array(out_counts, np.int64)


def merge_fld_prefixes(fl_vec: np.ndarray, goal: int) -> np.ndarray:
    """The global first `goal` fragment lengths: every rank's subsample
    (its own first lengths, in its read order) taken in rank order, which
    is the global read order."""
    buf = np.zeros(goal + 1, np.int64)
    buf[0] = fl_vec.shape[0]
    buf[1 : 1 + fl_vec.shape[0]] = fl_vec
    parts, need = [], goal
    for row in allgather_int64(buf):
        t = min(int(row[0]), need)
        if t > 0:
            parts.append(row[1 : 1 + t])
            need -= t
        if need == 0:
            break
    return np.concatenate(parts) if parts else np.empty(0, np.int64)
