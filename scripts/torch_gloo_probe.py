"""Which gloo collectives take CUDA tensors on this machine's torch, whether
they wait for the kernel that wrote their input, and what one costs.

    python3 scripts/torch_gloo_probe.py

Four ranks (processes) share card 0 under gloo, as chip_smoke.py's
`parallel` phase runs them. Each operation runs in a world of its own,
since gloo can abort the process on a CUDA tensor it does not take
(std::terminate) rather than raise: a world's exit codes say whether the
operation ran. The input of each is written by a kernel queued behind a
busy-wait of about 0.1 s, so a collective that read it without waiting
for the stream would return zeros. Prints one JSON line an operation,
then the card's nvidia-smi line.
"""

import datetime
import json
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

WORLD = 4
SLEEP_CYCLES = 200_000_000
LATENCY_CALLS = 100
OPS = ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
       "all_to_all_uneven", "send_recv", "latency")


def late(value: float, n: int, dev) -> torch.Tensor:
    """A tensor whose value a kernel writes after a busy-wait."""
    x = torch.zeros(n, device=dev)
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(value)
    return x


def run_op(name: str, rank: int, dev) -> dict:
    if name == "all_reduce":
        x = late(rank + 1.0, 4096, dev)
        dist.all_reduce(x)
        return dict(ok=bool((x == 10.0).all()))
    if name == "all_gather_into_tensor":
        out = torch.empty(2 * WORLD, device=dev)
        dist.all_gather_into_tensor(out, late(rank + 1.0, 2, dev))
        return dict(ok=out.tolist() == [1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0,
                                        4.0])
    if name == "all_to_all_single":
        out = torch.empty(WORLD, device=dev)
        dist.all_to_all_single(out, late(rank + 1.0, WORLD, dev))
        return dict(ok=out.tolist() == [1.0, 2.0, 3.0, 4.0])
    if name == "all_to_all_uneven":
        ins, outs = [0] * WORLD, [0] * WORLD
        ins[(rank + 1) % WORLD] = outs[(rank - 1) % WORLD] = 2
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, late(rank + 1.0, 2, dev), outs, ins)
        return dict(ok=out.tolist() == [float((rank - 1) % WORLD + 1)] * 2)
    if name == "send_recv":
        got = torch.empty(3, device=dev)
        ops = [dist.P2POp(dist.isend, late(rank + 1.0, 3, dev),
                          (rank + 1) % WORLD),
               dist.P2POp(dist.irecv, got, (rank - 1) % WORLD)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return dict(ok=got.tolist() == [float((rank - 1) % WORLD + 1)] * 3)
    if name == "latency":
        out = {}
        for d in (dev, torch.device("cpu")):
            x = torch.randn(4096, device=d)
            for _ in range(5):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LATENCY_CALLS):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            out[f"all_reduce_4096_f32_{d.type}_us"] = (
                (time.perf_counter() - t0) / LATENCY_CALLS * 1e6)
        return dict(ok=True, **out)
    raise ValueError(name)


def body(name: str, rank: int, rendezvous: str, results) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=rendezvous,
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    out = run_op(name, rank, torch.device("cuda", 0))
    torch.cuda.synchronize()
    results.put((rank, out))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_gloo_probe: needs an NVIDIA GPU")
    ctx = torch.multiprocessing.get_context("spawn")
    for name in OPS:
        results = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=body, args=(
                name, r, f"file://{tmp}/rendezvous", results))
                for r in range(WORLD)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
                    p.join()
        got = {}
        while not results.empty():
            rank, out = results.get()
            got[rank] = out
        print(json.dumps({"op": name, "torch": torch.__version__,
                          "exit_codes": [p.exitcode for p in procs],
                          "ranks": [got.get(r) for r in range(WORLD)]}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
