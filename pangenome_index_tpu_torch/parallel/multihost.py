"""Joining a process group, placing per-rank data, and the RLE stitch of a
distributed merge.

Counterpart of pangenome_index_tpu/parallel/multihost.py, one process a
card:

* init_distributed joins the group named by JAX's environment
  (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) or torchrun's (MASTER_ADDR,
  MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), or by its arguments; without
  either it does nothing. It picks the card by local rank, and the backend
  by the device (nccl for a card, gloo for the CPU).
* global_mesh(n_model): the (data, model) mesh over every process.
* put_global: each rank places only its own slice of arrays every rank holds
  on the host (the index read from the same files), and global_read_batch
  its slice of the reads, which its model peers share.
* stitch_rle_shards: a numpy copy of the JAX function.
* spawn_group: runs fn(rank, world, *args) in `world` processes on one host
  over a FileStore (no TCP port), this process being rank 0; the others are
  joined with a time limit and killed past it.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, backend_for, group_timeout, make_mesh, pick_device

#: seconds a spawned rank may outlive rank 0's return before it is killed
JOIN_SECONDS = 120


def _env_group(coordinator=None, num_processes=None, process_id=None):
    """(init_method, world, rank, local rank) from the arguments, JAX's
    environment or torchrun's, or None."""
    env = os.environ
    coordinator = coordinator or env.get("COORDINATOR_ADDRESS")
    if coordinator:
        rank = process_id if process_id is not None else int(env.get("PROCESS_ID", "0"))
        return (coordinator if "://" in coordinator else f"tcp://{coordinator}",
                num_processes or int(env.get("NUM_PROCESSES", "1")), rank, rank)
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
        rank = int(env["RANK"])
        return "env://", int(env["WORLD_SIZE"]), rank, int(env.get("LOCAL_RANK", rank))
    return None


def launched() -> bool:
    """Whether a process group is joined, or the environment names one."""
    return dist.is_initialized() or _env_group() is not None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> torch.device | None:
    """Join the process group from the arguments or the environment
    (COORDINATOR_ADDRESS host:port, NUM_PROCESSES, PROCESS_ID; or torchrun's
    variables); a no-op returning None without a coordinator. Returns this
    process's device: the card of its local rank, unless the caller asks
    for the CPU (device "cpu"); without a card, RuntimeError. The backend
    follows the device; a group joined already is kept."""
    if dist.is_initialized():
        return pick_device(device, dist.get_rank())
    found = _env_group(coordinator, num_processes, process_id)
    if found is None:
        return None
    init, world, rank, local = found
    dev = pick_device(device, local)
    dist.init_process_group(backend_for(dev), init_method=init, world_size=world,
                            rank=rank, timeout=group_timeout())
    return dev


def global_mesh(n_model: int = 1, device="cuda") -> Mesh:
    """The (data, model) mesh over every process of the group: n_data =
    world size // n_model, on a card unless the caller asks for the CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_model:
        raise ValueError(f"{world} processes do not split into model groups of {n_model}")
    return make_mesh(world // n_model, n_model, device)


def put_global(mesh: Mesh, tree: dict, specs: dict) -> dict:
    """Place host arrays that every rank holds: each entry of `tree` (numpy
    or a tensor) goes to the mesh's device whole (spec None), or only this
    rank's slice of its first dimension along the mesh axis named by its
    spec ("data" or "model"), the dimension a multiple of that axis's
    size. No rank copies a slice it does not own."""
    out = {}
    for name, a in tree.items():
        spec = specs.get(name)
        if spec is not None:
            S, i = mesh.axis_size(spec), mesh.axis_index(spec)
            if a.shape[0] % S:
                raise ValueError(f"{name}: {a.shape[0]} rows do not split over {S} shards")
            rows = a.shape[0] // S
            a = a[i * rows : (i + 1) * rows]
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out[name] = a.to(mesh.device)
    return out


def global_read_batch(mesh: Mesh, codes, lengths):
    """This rank's slice over `data` of a global read batch (codes [B, L],
    lengths [B], B a multiple of the data axis), on the mesh's device."""
    got = put_global(mesh, {"codes": codes, "lengths": lengths},
                     {"codes": "data", "lengths": "data"})
    return got["codes"], got["lengths"]


def stitch_rle_shards(shards: list[tuple[np.ndarray, np.ndarray]]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-rank RLE outputs over consecutive row ranges into one run
    list: where a shard's first run continues the previous shard's last run
    (equal value) the lengths are summed (merge_tags.cpp:640-684's first-run
    fix-up); empty shards are skipped."""
    vals_out: list[np.ndarray] = []
    lens_out: list[np.ndarray] = []
    prev_val, prev_len = None, 0
    for vals, lens in shards:
        if len(vals) == 0:
            continue
        lens = np.asarray(lens, np.int64)
        if prev_val is not None and vals[0] == prev_val:
            lens = lens.copy()
            lens[0] += prev_len
        elif prev_val is not None:
            vals_out.append(np.array([prev_val], np.int64))
            lens_out.append(np.array([prev_len], np.int64))
        vals_out.append(np.asarray(vals[:-1], np.int64))
        lens_out.append(lens[:-1])
        prev_val, prev_len = int(vals[-1]), int(lens[-1])
    if prev_val is not None:
        vals_out.append(np.array([prev_val], np.int64))
        lens_out.append(np.array([prev_len], np.int64))
    if not vals_out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(vals_out), np.concatenate(lens_out)


def _join_group(rank: int, world: int, store_path: str, device) -> torch.device:
    dev = pick_device(device, rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend_for(dev), store=store, rank=rank, world_size=world,
                            timeout=group_timeout())
    return dev


def _worker(fn, rank: int, world: int, store_path: str, device, args) -> None:
    torch.set_num_threads(1)
    _join_group(rank, world, store_path, device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_group(fn, world: int, args=(), device="cuda", join_seconds: float = JOIN_SECONDS):
    """fn(rank, world, *args) on `world` ranks of a new process group over a
    FileStore in a temporary directory: ranks 1.. in spawned processes,
    rank 0 in this one (its return value is returned). Each rank takes
    the card of its rank, or the CPU (gloo) with device "cpu". The spawned ranks are joined
    within join_seconds of rank 0's return and killed past it; one that
    failed or was killed raises RuntimeError. fn must be importable by
    name (a spawned process imports it)."""
    pick_device(device, 0)  # no card: refuse before any rank is started
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="panidx-group-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, args=(fn, r, world, store_path, device, args),
                             daemon=True) for r in range(1, world)]
        for p in procs:
            p.start()
        try:
            _join_group(0, world, store_path, device)
            try:
                out = fn(0, world, *args)
            finally:
                dist.destroy_process_group()
        finally:
            bad = []
            deadline = time.monotonic() + join_seconds
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
                    bad.append(f"rank {procs.index(p) + 1} did not end")
                elif p.exitcode != 0:
                    bad.append(f"rank {procs.index(p) + 1} exited with {p.exitcode}")
        if bad:
            raise RuntimeError("spawned ranks failed: " + "; ".join(bad))
    return out
