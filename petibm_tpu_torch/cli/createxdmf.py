"""petibm-createxdmf on the host (counterpart of
``petibm_tpu/cli/createxdmf.py``; reference:
applications/createxdmf/main.cpp): one <field>.xmf per field for the
snapshots of a run.

    python -m petibm_tpu_torch.cli.createxdmf -directory <case>
"""

from __future__ import annotations

import sys

from ..io.xdmf import write_single_xdmf
from ..mesh import StaggeredMesh
from ..types import Field
from .common import config_from_args, make_parser


def main(argv=None) -> int:
    ap = make_parser("Write XDMF metadata for saved solution snapshots",
                     device=False)
    ap.add_argument("-bg", "--bg", type=int, default=None)
    ap.add_argument("-ed", "--ed", type=int, default=None)
    ap.add_argument("-step", "--step", type=int, default=None)
    args = ap.parse_args(argv)
    config = config_from_args(args)
    mesh = StaggeredMesh(config)
    out = config["output"]

    params = config.get("parameters", {})
    bg = args.bg if args.bg is not None else int(params.get("startStep", 0))
    ed = args.ed if args.ed is not None else bg + int(params.get("nt", 0))
    step = args.step if args.step is not None else int(params.get("nsave", 1))

    def nvec(field):
        return [mesh.n(field, d) for d in range(mesh.dim)] + [1] * (3 - mesh.dim)

    fields = {"u": nvec(Field.U), "v": nvec(Field.V), "p": nvec(Field.P)}
    n4 = nvec(Field.VERTEX)
    n3 = nvec(Field.P)
    if mesh.dim == 2:
        fields["wz"] = [n4[0], n4[1], 1]
    else:
        fields["w"] = nvec(Field.W)
        fields["wx"] = [n3[0], n4[1], n4[2]]
        fields["wy"] = [n4[0], n3[1], n4[2]]
        fields["wz"] = [n4[0], n4[1], n3[2]]
    for name, n in fields.items():
        path = write_single_xdmf(out, name, mesh.dim, n, bg, ed, step)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
