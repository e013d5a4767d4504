"""HDF5/XDMF I/O with reference-compatible file layouts.

Copies of ``petibm_tpu/io/hdf5.py`` and ``petibm_tpu/io/xdmf.py`` (held
equal to the originals by tests/test_torch_host.py and
tests/test_torch_io.py).  h5py is imported inside each function: the
port runs without it, writing its text logs only (``hdf5_available``).
"""

from .hdf5 import (  # noqa: F401
    hdf5_available,
    read_restart_histories,
    read_solution,
    read_time,
    write_grid,
    write_restart_histories,
    write_solution,
    write_time,
)
