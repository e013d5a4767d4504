"""petibm-vorticity on PyTorch (counterpart of
``petibm_tpu/cli/vorticity.py``; reference: applications/vorticity/
main.cpp): the vorticity of saved snapshots, appended to their HDF5 files,
and the vorticity grids appended to grid.h5.  Needs h5py.

    python -m petibm_tpu_torch.cli.vorticity -directory <case> [-device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..boundary import BoundarySet
from ..io.vorticity import compute_vorticity, vorticity_meshes
from ..mesh import StaggeredMesh
from .common import config_from_args, parse_args

DIR_NAMES = ("x", "y", "z")


def main(argv=None) -> int:
    import h5py

    def extra(ap):
        ap.add_argument("-bg", "--bg", type=int, default=None)
        ap.add_argument("-ed", "--ed", type=int, default=None)
        ap.add_argument("-step", "--step", type=int, default=None)

    args = parse_args("Compute vorticity for saved solution snapshots",
                      argv, extra=extra)
    config = config_from_args(args)
    mesh = StaggeredMesh(config)
    bcset = BoundarySet(mesh, config)
    out = config["output"]

    # the vorticity grids into grid.h5 (main.cpp:98-108)
    with h5py.File(os.path.join(out, "grid.h5"), "a") as fh:
        for name, coords in vorticity_meshes(mesh).items():
            if name in fh:
                del fh[name]
            g = fh.create_group(name)
            for d, c in enumerate(coords):
                g.create_dataset(DIR_NAMES[d], data=np.asarray(c, np.float64))

    params = config.get("parameters", {})
    bg = args.bg if args.bg is not None else int(params.get("startStep", 0))
    ed = args.ed if args.ed is not None else bg + int(params.get("nt", 0))
    step = args.step if args.step is not None else int(params.get("nsave", 1))

    names = [("u", "v", "w")[c] for c in range(mesh.dim)]
    for ite in range(bg, ed + 1, step):
        path = os.path.join(out, f"{ite:07d}.h5")
        if not os.path.isfile(path):
            print(f"skip missing {path}")
            continue
        with h5py.File(path, "r") as fh:
            q = {n: torch.as_tensor(np.asarray(fh[n]), device=args.device)
                 for n in names}
        w = compute_vorticity(mesh, bcset, q, bcset.init_state(q))
        with h5py.File(path, "a") as fh:
            for name, arr in w.items():
                if name in fh:
                    del fh[name]
                fh.create_dataset(name, data=arr.cpu().numpy().astype(
                    np.float64))
        print(f"[time step {ite}] wrote {', '.join(w)} to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
