"""Which process-group backend carries two ranks that share one CUDA card.

NCCL refuses two ranks of one communicator on one device ("Duplicate GPU
detected"): it compares each rank's host hash and bus id.  This script
launches two ranks on ``cuda:0`` once for each variant below, each
variant in processes of its own with a time limit, and prints one JSON
line per variant: whether an all-reduce, an uneven ``all_to_all_single``
and a pair of tagged ``isend``/``irecv`` on cuda tensors came out right,
the error if one did not, and the mean time of each over 50 calls.

  nccl           NCCL as it comes
  nccl_hostid    NCCL with a host id of its own per rank
                 (``NCCL_HOSTID``), the socket transport on ``lo``
  gloo_staged    gloo, each cuda tensor copied to a host buffer for the
                 collective and back (gloo takes no cuda tensor for
                 ``all_to_all_single`` or ``isend``)

    python3 scripts/probe_nccl_one_card.py          # needs one card
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

VARIANTS = {
    "nccl": ("nccl", {}),
    "nccl_hostid": ("nccl", {"NCCL_SOCKET_IFNAME": "lo",
                             "NCCL_IB_DISABLE": "1", "NCCL_P2P_DISABLE": "1",
                             "NCCL_SHM_DISABLE": "1"}),
    "gloo_staged": ("gloo", {}),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(variant: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    backend, _ = VARIANTS[variant]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    staged = backend == "gloo"

    def host(t):
        return t.cpu() if staged else t

    def back(t):
        return t.to(dev) if staged else t

    out = {"variant": variant, "rank": rank}
    x = torch.full((1 << 16,), float(rank + 1), device=dev)

    def allreduce():
        y = host(x.clone())
        dist.all_reduce(y)
        return back(y)

    ins, outs = ([3, 5], [3, 2]) if rank == 0 else ([2, 6], [5, 6])

    def alltoall():
        src = host(torch.arange(8, dtype=torch.float32, device=dev)
                   + 10 * rank)
        dst = torch.empty(sum(outs), dtype=torch.float32, device=src.device)
        dist.all_to_all_single(dst, src, outs, ins)
        return back(dst)

    def p2p():
        peer = 1 - rank
        a = host(torch.full((4,), float(rank), device=dev))
        b = host(torch.full((4,), rank + 0.5, device=dev))
        ra, rb = torch.empty_like(a), torch.empty_like(b)
        ops = [dist.P2POp(dist.isend, a, peer, tag=1),
               dist.P2POp(dist.isend, b, peer, tag=2),
               dist.P2POp(dist.irecv, ra, peer, tag=1),
               dist.P2POp(dist.irecv, rb, peer, tag=2)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return back(ra), back(rb)

    try:
        got = allreduce()
        out["allreduce_ok"] = bool(torch.all(got == 3.0).item())
        got = alltoall().cpu().tolist()
        want = ([0.0, 1.0, 2.0, 10.0, 11.0] if rank == 0
                else [3.0, 4.0, 5.0, 6.0, 7.0, 12.0, 13.0, 14.0, 15.0, 16.0,
                      17.0])
        out["alltoall_ok"] = got == want
        ra, rb = p2p()
        peer = 1 - rank
        out["p2p_ok"] = (bool(torch.all(ra == peer).item())
                         and bool(torch.all(rb == peer + 0.5).item()))
        for name, fn in (("allreduce", allreduce), ("alltoall", alltoall),
                         ("p2p", p2p)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            out[f"{name}_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    except Exception as err:  # reported, the variant's verdict
        out["error"] = f"{type(err).__name__}: {err}"[:400]
    print("PROBE " + json.dumps(out), flush=True)
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.nccl.version() if hasattr(torch.cuda, "nccl") else "")
    for variant, (_, extra) in VARIANTS.items():
        port = _free_port()
        procs = []
        for rank in range(2):
            env = dict(os.environ, **extra)
            if variant == "nccl_hostid":
                env["NCCL_HOSTID"] = f"petibm-rank-{rank}"
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", variant, str(rank),
                 str(port)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                out += "\nPROBE " + json.dumps(
                    {"variant": variant, "rank": rank, "error": "timeout"})
            lines = [ln for ln in out.splitlines() if ln.startswith("PROBE ")]
            print(lines[-1] if lines else
                  "PROBE " + json.dumps({"variant": variant, "rank": rank,
                                         "error": err.strip()[-400:]}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(main())
