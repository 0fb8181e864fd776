"""The distributed backend of the PyTorch port under ``torchrun``: every rank
calls ``eigsh`` on the same matrix, each converts and multiplies its own
nnz-balanced row shard, and every rank gets the whole result.

On the CPU (gloo), two ranks:

    PYTHONPATH=src torchrun --nproc-per-node 2 examples/distributed_eigs_torch.py --device cpu

On one card per rank (NCCL), or G ranks sharing one card (gloo, which
stages the collectives through the host):

    PYTHONPATH=src torchrun --nproc-per-node 1 examples/distributed_eigs_torch.py
    PYTHONPATH=src torchrun --nproc-per-node 2 examples/distributed_eigs_torch.py --backend gloo
"""

import argparse
import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro_torch
from repro_torch.sparse import generate


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: nccl on the card)")
    ap.add_argument("--n", type=int, default=1 << 16, help="rows of the road network")
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    # A finite timeout: a rank that fails alone ends the others' collectives.
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=5))
    try:
        mesh = init_device_mesh(args.device, (dist.get_world_size(),), mesh_dim_names=("data",))
        A = generate("road", args.n, 2.1, seed=0)
        res = repro_torch.eigsh(A, k=args.k, mesh=mesh, device=args.device)
        if dist.get_rank() == 0:
            part = res.partition
            print(f"backend={res.backend} ranks={res.num_devices} format={res.spmv_format[0]} "
                  f"splits={part['splits']} n_pad={part['n_pad']}")
            print(f"eigenvalues {res.eigenvalues.cpu().tolist()}")
            print(f"collectives {res.timings['collective_s'] * 1e3:.1f} ms of a "
                  f"{res.timings['lanczos_s'] * 1e3:.1f} ms Lanczos loop")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
