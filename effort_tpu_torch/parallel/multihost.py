"""Multi-process runtime: joining a process group, host-major meshes, and
starting local ranks.

  - init_multihost(): wraps torch.distributed.init_process_group, as the
    JAX package's wraps jax.distributed.initialize; with nothing to join it
    does nothing and returns (0, 1).
  - make_pod_mesh(): a DeviceMesh whose axes are each split into a host
    (DCN) factor, outer, and a within-host factor, inner: the rank order of
    jax.experimental.mesh_utils.create_hybrid_device_mesh.
  - spawn(): local ranks, one process each.

Deviation from the JAX package, on purpose: JAX runs every device of a host
in one process, and its parallel code runs inside shard_map there. The
port runs one process a rank (torch.distributed's model), so a mesh of n
ranks is n processes and a test or script that wants n ranks on one host
starts them: spawn() runs fn in n processes of the spawn context, joined
through a file:// rendezvous in a temporary directory (no port to pick, so
concurrent runs cannot clash), and returns each rank's result to the
caller. The backend is an explicit choice: "nccl" where each rank has a
card of its own; "gloo" on the CPU, or where ranks share a card (NCCL
refuses two ranks on one GPU); a failed init raises and nothing switches
backend quietly.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    return address if "://" in address else "tcp://" + address


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device=None) -> Tuple[int, int]:
    """Join (or create) the process group: coordinator_address is a
    torch.distributed init method ("tcp://host:port", "file:///path"; a
    bare "host:port" means tcp), num_processes the world size, process_id
    this rank. backend defaults to "nccl" when `device` is a card and to
    "gloo" otherwise; pass "gloo" for ranks that share a card. Returns
    (rank, world size); with nothing to join (one process, no address) it
    initializes nothing and returns (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not ((num_processes is not None and num_processes > 1)
            or coordinator_address is not None):
        return 0, 1
    dev = torch.device(device) if device is not None else None
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" else "gloo"
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=300))
    return dist.get_rank(), dist.get_world_size()


def pod_mesh_ranks(dcn_axes: Sequence[int], ici_axes: Sequence[int],
                   n_hosts: int) -> np.ndarray:
    """The rank array of a pod mesh: ranks numbered host by host
    (world = n_hosts * prod(ici_axes)); axis i of size dcn[i] * ici[i],
    the host factor outer (create_hybrid_device_mesh's np.block of
    per-host meshes)."""
    dcn, ici = list(dcn_axes), list(ici_axes)
    n_local = int(np.prod(ici))
    if int(np.prod(dcn)) not in (n_hosts, 1):
        raise ValueError(f"dcn_axes {dcn} do not cover {n_hosts} hosts")
    ranks = np.arange(int(np.prod(dcn)) * n_local).reshape(dcn + ici)
    k = len(dcn)
    order = [a for i in range(k) for a in (i, k + i)]
    return ranks.transpose(order).reshape([d * i for d, i in zip(dcn, ici)])


def make_pod_mesh(axis_names: Sequence[str] = ("dp", "tp"),
                  dcn_axes: Sequence[int] = (1,),
                  ici_axes: Optional[Sequence[int]] = None,
                  n_hosts: int = 1, device_type: str = "cpu"):
    """A DeviceMesh over every rank of the process group, host-major.

    dcn_axes[i] is the size of axis_names[i] across hosts (padded with 1s;
    product n_hosts), ici_axes the within-host sizes (product: the ranks a
    host runs, world // n_hosts; by default all on the last axis). One
    host with dcn_axes of 1s is a plain mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_local = world // n_hosts
    dcn = list(dcn_axes) + [1] * (len(axis_names) - len(dcn_axes))
    ici = (list(ici_axes) if ici_axes is not None
           else [1] * (len(axis_names) - 1) + [n_local])
    if len(ici) != len(axis_names):
        raise ValueError(f"ici_axes must give one factor per axis name: "
                         f"{ici} {tuple(axis_names)}")
    if int(np.prod(ici)) != n_local:
        raise ValueError(f"ici_axes {ici} vs {n_local} ranks a host")
    ranks = pod_mesh_ranks(dcn, ici, n_hosts)
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axis_names))


def device_type_of(device) -> str:
    return torch.device(device).type


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               rendezvous: str, args: tuple, results) -> None:
    """One spawned rank: join, run fn(rank, world, device, *args), post
    ("ok", result) or ("error", traceback) to the parent."""
    torch.set_num_threads(1)
    try:
        init_multihost(rendezvous, world, rank, backend=backend,
                       device=device)
        out = fn(rank, world, device, *args)
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_procs: int, backend: str, device_of_rank=None, *args,
          timeout: float = 600.0) -> list:
    """Run fn(rank, world, device, *args) in n_procs new processes (the
    spawn context), joined into one process group (`backend`) through a
    file:// rendezvous in a temporary directory; return the ranks' results
    in rank order. fn and args must pickle (fn a module-level function of
    an importable module). device_of_rank: a device for every rank (a
    string), a list of one per rank, or a function of the rank, called
    here; None means the CPU. Raises if a rank fails, or if any has not
    finished after `timeout` seconds; every process is stopped before it
    returns or raises."""
    if callable(device_of_rank):
        devices = [str(device_of_rank(r)) for r in range(n_procs)]
    elif isinstance(device_of_rank, (list, tuple)):
        devices = [str(d) for d in device_of_rank]
    else:
        devices = [str(device_of_rank or "cpu")] * n_procs
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="effort_rdv_") as tmp:
        rendezvous = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n_procs, backend, devices[r],
                                   rendezvous, args, results))
                 for r in range(n_procs)]
        for p in procs:
            p.start()
        got, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(errors) < n_procs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(n_procs)) - set(got))} "
                        f"not done after {timeout} s")
                try:
                    rank, status, out = results.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in got
                            and r not in errors and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} exited with "
                            f"{[procs[r].exitcode for r in dead]}")
                    continue
                (got if status == "ok" else errors)[rank] = out
                if errors:
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            r = min(errors)
            raise RuntimeError(f"rank {r} of {n_procs} failed:\n{errors[r]}")
    return [got[r] for r in range(n_procs)]
