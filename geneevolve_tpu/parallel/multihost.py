"""Multi-host execution support: `jax.distributed` initialization and
per-host output ownership.

The reference is a single process (`SURVEY.md` §2.4); on a multi-host
cluster each host drives its local devices and owns an individuals-slice of every sharded
array. This module provides:

- `maybe_init_distributed()`: initialize `jax.distributed` from standard
  environment (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID,
  or the GE_* spellings), a no-op in single-process runs. Must be called
  before the backend is touched — the CLI calls it first thing.
- `process_info()`: (process_index, process_count) without requiring
  initialization.
- `host_row_ranges(arr)`: the [lo, hi) row ranges of `arr`'s first axis
  that THIS host's addressable shards cover — the rows its output writers
  are responsible for. With every genome array sharded over 'ind', each
  host paints and writes only its own individuals
  (`<prefix>...hostK.hap` etc.), replacing the reference's single-process
  output loops (`/root/reference/src/Simulation.cpp:1186-1230`) with
  embarrassingly parallel per-host streams.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import jax


def maybe_init_distributed() -> Tuple[int, int]:
    """Initialize jax.distributed when a coordinator is configured;
    returns (process_index, process_count). Safe to call twice."""
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "GE_COORDINATOR_ADDRESS"
    )
    nproc = os.environ.get("JAX_NUM_PROCESSES") or os.environ.get(
        "GE_NUM_PROCESSES"
    )
    pid = os.environ.get("JAX_PROCESS_ID") or os.environ.get("GE_PROCESS_ID")
    if coord and nproc is not None and pid is not None:
        try:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(nproc),
                process_id=int(pid),
            )
        except RuntimeError:
            pass  # already initialized
    return process_info()


def process_info() -> Tuple[int, int]:
    return jax.process_index(), jax.process_count()


def host_suffix() -> str:
    """Filename suffix marking this host's output shard; empty when
    single-process (single files, byte-compatible with the reference)."""
    idx, count = process_info()
    return f".host{idx}" if count > 1 else ""


def host_row_ranges(arr, axis: int = 0) -> List[Tuple[int, int]]:
    """Sorted, merged [lo, hi) ranges of `axis` covered by this process's
    addressable shards of `arr`. For a process-local (unsharded) array this
    is [(0, n)]."""
    n = arr.shape[axis]
    try:
        shards = arr.addressable_shards
    except AttributeError:
        return [(0, n)]
    ranges = []
    for s in shards:
        idx = s.index[axis] if axis < len(s.index) else slice(None)
        lo, hi, step = idx.indices(n)
        assert step == 1
        ranges.append((lo, hi))
    ranges = sorted(set(ranges))
    merged: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return merged
