"""Data parallelism over devices along the reads axis (K18).

Port of kallisto_tpu/parallel/mesh.py.  The reference's only parallelism
is pthreads over read batches merged under a writer lock
(src/ProcessReads.cpp:307-646, MasterProcessor::update 424-646); the JAX
package shard_maps one program over a 1-D `reads` mesh.  Here a mesh is a
list of torch devices, one per shard:

- the index is replicated once per DISTINCT device; shards on the same
  device share its replica (1.135 GB at the smoke's index);
- each read batch is padded to a multiple of the shard count with
  `lens = 0` reads (no k-mer window: the no-hit key, never counted) and
  split contiguously -- shard s holds reads [s*B/n, (s+1)*B/n), so read
  order is preserved across shards;
- each shard runs kernels A and E (K17: ops/pseudoalign.py
  pseudoalign_pair/single_compact_packed) on its own device, every shard
  launched before any is fetched; the key tables come back in mesh order,
  and the host walks them in that order (quant/pipeline.py's `cmesh`
  route), which reproduces the one-device run's first-seen key order, so
  EC ids, counts and est_counts are bit-identical to it;
- the per-read route runs kernel A per shard and concatenates the
  results in mesh order on the first device, padding sliced off.

On CUDA, shard s lands on cuda:((base + s) % device_count), base being
the requested device's index; with one card every shard shares it.  On
the CPU the shards are logical: n shards of one device, the port's form
of the virtual CPU devices JAX's tests run on.  Nothing here is a
collective: a shard's work is its own, and the merge is the host's.  A
one-shard mesh is the one-device run: no padding, one replica, and the
per-read route returns its shard's result as it is.
"""

from typing import List, Tuple

import numpy as np
import torch

from ..io.fastx import PackedBatch
from ..ops.pseudoalign import (
    AnyDeviceIndex,
    SideResult,
    device_index_from_host,
    pseudoalign_batch_packed,
    pseudoalign_pair_compact_packed,
    pseudoalign_single_compact_packed,
    upload_batch,
)


def n_shards(opt, dev: torch.device, tcc: bool = False) -> int:
    """How many shards a run spreads over.  An explicit opt.n_devices
    gives that many; `-t N` asks for up to N cards (the reference's -t is
    thread parallelism over read batches, src/ProcessReads.cpp:307-320),
    the CPU counting as one.  quant-tcc takes JAX's count (tcc.py:246):
    the larger of the two."""
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    by_threads = min(opt.threads, have)
    if tcc:
        return max(opt.n_devices, by_threads, 1)
    return max(opt.n_devices or by_threads, 1)


def make_mesh(n: int, device) -> List[torch.device]:
    """The devices of n shards: n logical shards of the CPU, or on CUDA
    shard s on cuda:((base + s) % device_count) from the requested
    device's index (the current device when it names none)."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    base = dev.index if dev.index is not None else torch.cuda.current_device()
    return [torch.device("cuda", (base + s) % count) for s in range(n)]


class MeshRunner:
    """Sharded pseudoalignment over `devices`, one shard per entry (a
    device may repeat).  replicate() places the index; the other methods
    take host batches and return per-shard device results."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.ndev = len(self.devices)
        self.didxs: List[AnyDeviceIndex] = []

    def replicate(self, index, with_pos_tables: bool = False
                  ) -> List[AnyDeviceIndex]:
        """One index replica per distinct device; returns (and keeps) the
        per-shard list, repeated devices sharing one replica."""
        reps = {}
        for d in self.devices:
            if d not in reps:
                reps[d] = device_index_from_host(
                    index, d, with_pos_tables=with_pos_tables)
        self.didxs = [reps[d] for d in self.devices]
        return self.didxs

    def put_batch(self, b: PackedBatch
                  ) -> Tuple[List[Tuple[torch.Tensor, ...]], int]:
        """Pad a batch to a multiple of the shard count with lens = 0
        reads and upload shard s's contiguous slice to its device.
        Returns ([(packed, nmask, lens)] in mesh order, reads per shard)."""
        sb = -(-b.n // self.ndev)
        pad = sb * self.ndev - b.n
        packed, nmask, lens = b.packed, b.nmask, b.lens
        if pad:
            packed = np.concatenate(
                [packed, np.zeros((pad, packed.shape[1]), np.uint8)])
            nmask = np.concatenate(
                [nmask, np.zeros((pad, nmask.shape[1]), np.uint8)])
            lens = np.concatenate([lens, np.zeros(pad, np.int32)])
        out = []
        for s, d in enumerate(self.devices):
            lo, hi = s * sb, (s + 1) * sb
            out.append(upload_batch(
                PackedBatch(packed[lo:hi], nmask[lo:hi], lens[lo:hi], b.Lp),
                d))
        return out, sb

    def pair_compact(self, b1: PackedBatch, b2: PackedBatch, k: int,
                     max_rows: int = 16, min_range: int = 0,
                     strand_key: bool = False, pos_fl: int = -1,
                     pos_depth: int = 0):
        """The sharded pair step (JAX MeshRunner.pair_compact): kernels A
        on both mates and E (the compact keys and the table) per shard, on
        the shard's device.  Each key table holds one more row than its
        shard has reads, so it cannot overflow.  Returns (r1s, r2s, cks,
        shard_B): the SideResults and [shard_B + 1, 5] key tables in mesh
        order, and the reads per shard (first-read offsets)."""
        up1, sb = self.put_batch(b1)
        up2, _ = self.put_batch(b2)
        r1s, r2s, cks = [], [], []
        for didx, u1, u2 in zip(self.didxs, up1, up2):
            r1, r2, ck = pseudoalign_pair_compact_packed(
                didx, *u1, *u2, k=k, L=b1.Lp, max_rows=max_rows,
                max_keys=sb + 1, min_range=min_range, strand_key=strand_key,
                pos_fl=pos_fl, pos_depth=pos_depth)
            r1s.append(r1)
            r2s.append(r2)
            cks.append(ck)
        return r1s, r2s, cks, sb

    def single_compact(self, b1: PackedBatch, k: int, max_rows: int = 16,
                       min_range: int = 0, strand_key: bool = False,
                       pos_fl: int = -1, pos_depth: int = 0):
        """The sharded single-end step: (r1s, cks, shard_B)."""
        up1, sb = self.put_batch(b1)
        r1s, cks = [], []
        for didx, u1 in zip(self.didxs, up1):
            r1, ck = pseudoalign_single_compact_packed(
                didx, *u1, k=k, L=b1.Lp, max_rows=max_rows, max_keys=sb + 1,
                min_range=min_range, strand_key=strand_key, pos_fl=pos_fl,
                pos_depth=pos_depth)
            r1s.append(r1)
            cks.append(ck)
        return r1s, cks, sb

    def pseudoalign_batch(self, b: PackedBatch, k: int,
                          max_rows: int = 16) -> SideResult:
        """The sharded per-read route (JAX pipeline.py:925-931): kernel A
        on each shard's device, the shards' results concatenated in mesh
        order on the first device with the padding sliced off -- the
        SideResult of the b.n reads (one shard's own, unpadded)."""
        ups, _ = self.put_batch(b)
        parts = [pseudoalign_batch_packed(didx, *u, k=k, L=b.Lp,
                                          max_rows=max_rows)
                 for didx, u in zip(self.didxs, ups)]
        if self.ndev == 1:
            return parts[0]
        dev = self.devices[0]
        return SideResult(*(
            torch.cat([t.to(dev) for t in fields])[: b.n]
            for fields in zip(*parts)))
