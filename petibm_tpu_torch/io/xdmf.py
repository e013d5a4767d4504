"""XDMF writer for VisIt/ParaView.

Reference (applications/createxdmf/main.cpp:128-266 writeSingleXDMF): one
<name>.xmf per field with entity macros for the grid sizes, a temporal grid
collection, 3DRectMesh topology referencing grid.h5 gridlines and the
per-step <0-padded>.h5 dataset (2D uses a dummy z axis).

Copy of ``petibm_tpu/io/xdmf.py`` (held equal to the original by
tests/test_torch_io.py).
"""

from __future__ import annotations

import os

DIR_NAMES = ("x", "y", "z")


def write_single_xdmf(directory: str, name: str, dim: int, n, bg: int,
                      ed: int, step: int) -> str:
    """Write <directory>/<name>.xmf; ``n`` is (nx, ny, nz)."""
    path = os.path.join(directory, f"{name}.xmf")
    lines = ["<?xml version='1.0' ?>", "",
             '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" [',
             '\t<!ENTITY CaseDir "./">']
    for d in range(3):
        nd = n[d] if d < len(n) and n[d] else 1
        lines.append(f'\t<!ENTITY N{DIR_NAMES[d]} "{nd}">')
    lines.append("\t<!ENTITY Topo \"<Topology TopologyType='3DRectMesh' "
                 "Dimensions='&Nz; &Ny; &Nx;'/>\">")
    lines.append("\t<!ENTITY Geo")
    lines.append("\t\t\"<Geometry GeometryType='VXVYVZ'>")
    for d in range(dim):
        dn = DIR_NAMES[d]
        lines.append(f"\t\t\t<DataItem Dimensions='&N{dn};' Format='HDF' "
                     f"Precision='8'>\n\t\t\t\t&CaseDir;/grid.h5:/{name}/{dn}\n"
                     "\t\t\t</DataItem>")
    if dim == 2:
        lines.append("\t\t\t<DataItem Dimensions='&Nz;' Format='XML' "
                     "Precision='8'>\n\t\t\t\t0.0\n\t\t\t</DataItem>")
    lines.append('\t\t</Geometry>"')
    lines.append("\t>")
    lines.append("]>")
    lines.append("")
    lines.append('<Xdmf Version="3.0">')
    lines.append("\t<Domain>")
    lines.append('\t<Grid GridType="Collection" CollectionType="Temporal">')
    for t in range(bg, ed + 1, step):
        lines.append(f'\t\t<Grid GridType="Uniform" Name="{name} Grid">')
        lines.append(f'\t\t\t<Time Value="{t:07d}" />')
        lines.append("\t\t\t&Topo; &Geo;")
        lines.append(f'\t\t\t<Attribute Name="{name}" AttributeType="Scalar" '
                     'Center="Node">')
        lines.append('\t\t\t\t<DataItem Dimensions="&Nz; &Ny; &Nx;" '
                     'Format="HDF" NumberType="Float" Precision="8">')
        lines.append(f"\t\t\t\t\t&CaseDir;/{t:07d}.h5:/{name}")
        lines.append("\t\t\t\t</DataItem>")
        lines.append("\t\t\t</Attribute>")
        lines.append("\t\t</Grid>")
    lines.append("\t</Grid>")
    lines.append("\t</Domain>")
    lines.append("</Xdmf>")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
