"""Whether NCCL collectives of two ranks on one card can be captured into a
CUDA graph, at its top level and inside a conditional IF node's body.

The chunked step of a decomposed run captures each rank's step as one CUDA
graph, and its solver loops as capped copies of their bodies under IF
nodes (``utils/graphs.py``, ``csrc/graph_cond.cu``); those bodies hold the
loops' collectives.  Two ranks share one card with a host id of their own
each (``NCCL_HOSTID``), so NCCL takes its socket transport
(``scripts/probe_nccl_one_card.py``).  This script launches two ranks on
``cuda:0`` once for each variant below, each in processes of its own with
a time limit, and prints one JSON line per variant and rank: whether the
capture and three replays gave the right values, or the error.

  graph_allreduce   ``all_reduce`` at the graph's top level
  graph_p2p         a ``batch_isend_irecv`` pair at the top level
  graph_alltoall    an uneven ``all_to_all_single`` at the top level
  if_allreduce      ``all_reduce`` inside an IF body (replayed with the
                    predicate true, then false)
  if_p2p            the send/recv pair inside an IF body
  if_alltoall       the all-to-all inside an IF body

    python3 scripts/probe_nccl_graph_if.py          # needs one card
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

VARIANTS = ("graph_allreduce", "graph_p2p", "graph_alltoall",
            "if_allreduce", "if_p2p", "if_alltoall")
NCCL_ENV = {"NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1",
            "NCCL_P2P_DISABLE": "1", "NCCL_SHM_DISABLE": "1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(variant: str, rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from petibm_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    peer = 1 - rank
    out = {"variant": variant, "rank": rank}
    ins, outs = ([3, 5], [3, 2]) if rank == 0 else ([2, 6], [5, 6])
    x = torch.zeros(1 << 12, device=dev)
    a2a_src = torch.zeros(8, device=dev)
    a2a_dst = torch.zeros(sum(outs), device=dev)
    send = torch.zeros(4, device=dev)
    recv = torch.zeros(4, device=dev)

    def allreduce():
        dist.all_reduce(x)

    def p2p():
        ops = [dist.P2POp(dist.isend, send, peer),
               dist.P2POp(dist.irecv, recv, peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def alltoall():
        dist.all_to_all_single(a2a_dst, a2a_src, outs, ins)

    op = {"allreduce": allreduce, "p2p": p2p,
          "alltoall": alltoall}[variant.split("_", 1)[1]]

    def fill(k: float) -> None:
        x.fill_(rank + k)
        send.fill_(10 * rank + k)
        recv.zero_()
        a2a_src.copy_(torch.arange(8, dtype=torch.float32, device=dev)
                      + 10 * rank + k)
        a2a_dst.zero_()

    def right(k: float) -> bool:
        name = variant.split("_", 1)[1]
        if name == "allreduce":
            return bool(torch.all(x == 1 + 2 * k).item())
        if name == "p2p":
            return bool(torch.all(recv == 10 * peer + k).item())
        lo = [0.0, 1.0, 2.0, 10.0, 11.0] if rank == 0 else \
            [3.0, 4.0, 5.0, 6.0, 7.0, 12.0, 13.0, 14.0, 15.0, 16.0, 17.0]
        return a2a_dst.cpu().tolist() == [v + k for v in lo]

    try:
        stream = torch.cuda.Stream(dev)
        # communicators and P2P channels made outside the capture
        with torch.cuda.stream(stream):
            fill(0.0)
            op()
        torch.cuda.synchronize()
        out["eager_ok"] = right(0.0)
        pred = torch.ones((), dtype=torch.bool, device=dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle()
        guard = graphs.IfNodes(dev) if variant.startswith("if_") else None
        torch.cuda.synchronize()
        with graphs.capture(graph, pool, stream):
            if guard is None:
                op()
            else:
                with guard(pred):
                    op()
        graph.instantiate()
        torch.cuda.synchronize()
        out["captured"] = True
        oks = []
        for k in (1.0, 2.0, 3.0):
            fill(k)
            torch.cuda.synchronize()
            graph.replay()
            torch.cuda.synchronize()
            oks.append(right(k))
        out["replays_ok"] = oks
        if guard is not None:
            pred.fill_(False)
            fill(4.0)
            torch.cuda.synchronize()
            graph.replay()
            torch.cuda.synchronize()
            # a skipped body leaves the outputs as filled
            out["skipped_ok"] = not right(4.0)
    except Exception as err:  # reported, the variant's verdict
        out["error"] = f"{type(err).__name__}: {err}"[:600]
    print("PROBE " + json.dumps(out), flush=True)
    os._exit(0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(torch.__version__, torch.version.cuda, torch.cuda.nccl.version())
    # build graph_cond once, before the ranks start
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from petibm_tpu_torch import _kernels

    _kernels.library("graph_cond")
    for variant in VARIANTS:
        port = _free_port()
        procs = []
        for rank in range(2):
            env = dict(os.environ, **NCCL_ENV,
                       NCCL_HOSTID=f"petibm-rank-{rank}")
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank", variant, str(rank),
                 str(port)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                out += "\nPROBE " + json.dumps(
                    {"variant": variant, "rank": rank, "error": "timeout",
                     "stderr": err.strip()[-600:]})
            lines = [ln for ln in out.splitlines() if ln.startswith("PROBE ")]
            print(lines[-1] if lines else
                  "PROBE " + json.dumps({"variant": variant, "rank": rank,
                                         "error": err.strip()[-600:]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(main())
