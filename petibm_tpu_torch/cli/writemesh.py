"""petibm-writemesh on the host (counterpart of
``petibm_tpu/cli/writemesh.py``; reference:
applications/writemesh/main.cpp:26-60): parse the config, write grid.h5
only (h5py required).

    python -m petibm_tpu_torch.cli.writemesh -directory <case>
"""

from __future__ import annotations

import os
import sys

from .. import io as pio
from ..mesh import StaggeredMesh
from .common import config_from_args, make_parser


def main(argv=None) -> int:
    args = make_parser("Write the staggered grid to grid.h5",
                       device=False).parse_args(argv)
    config = config_from_args(args)
    mesh = StaggeredMesh(config)
    path = os.path.join(config["output"], "grid.h5")
    pio.write_grid(mesh, path)
    print(mesh.info())
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
