"""What this machine's torch.distributed takes on the card.

    python3 tools/dist_probe.py

Two gloo ranks on cuda:0 (spawned, a file rendezvous in a temp directory):
`all_reduce` of CUDA tensors of each dtype the parallel package sends
(float32, uint8, int64, bfloat16), its host-clock time for 4 MB and 50 MB
buffers, and whether a CUDA graph can capture it. Then one NCCL rank: an
`all_reduce` under `torch.cuda.set_sync_debug_mode("error")` (a collective
that waits for the host raises there) and one captured in a CUDA graph and
replayed three times. Prints one line per finding; needs a card.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=60)


def _gloo_rank(rank: int, world: int, path: str, queue) -> None:
    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=world, rank=rank, timeout=TIMEOUT)
    dev = torch.device("cuda:0")
    out = {}
    for dt in (torch.float32, torch.uint8, torch.int64, torch.bfloat16):
        t = torch.full((10,), rank + 1, dtype=dt, device=dev)
        dist.all_reduce(t)
        out[str(dt)] = f"cuda {t.is_cuda}, sum {t[0].item()} (expect {sum(range(1, world + 1))})"
    for n in (1 << 20, 12 << 20):
        t = torch.ones(n, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        out[f"all_reduce of {4 * n / 1e6:.1f} MB"] = f"{(time.perf_counter() - t0) / 5 * 1e3:.3f} ms"
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            dist.all_reduce(torch.ones(4, device=dev))
        out["capture"] = "captured"
    except RuntimeError as e:
        out["capture"] = f"refused: {type(e).__name__}"
    queue.put((rank, out))
    dist.destroy_process_group()


def _nccl_rank(path: str) -> None:
    dist.init_process_group("nccl", init_method=f"file://{path}", world_size=1, rank=0, timeout=TIMEOUT)
    x = torch.ones(1000, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dist.all_reduce(x)
        print("nccl all_reduce under sync debug 'error': no host wait")
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    graph, y = torch.cuda.CUDAGraph(), torch.zeros(1000, device="cuda")
    with torch.cuda.graph(graph):
        z = x * 2
        dist.all_reduce(z)
        y.add_(z)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    print(f"nccl all_reduce captured and replayed 3 times: {y[0].item()} (expect 6.0)")
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    work = tempfile.mkdtemp(prefix="dist_probe_")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, os.path.join(work, "gloo"), queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted(queue.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(60)
    for rank, out in results:
        for k, v in out.items():
            print(f"gloo rank {rank} on cuda:0, {k}: {v}")
    p = ctx.Process(target=_nccl_rank, args=(os.path.join(work, "nccl"),))
    p.start()
    p.join(300)
    return 0 if p.exitcode == 0 and all(q.exitcode == 0 for q in procs) else 1


if __name__ == "__main__":
    sys.exit(main())
