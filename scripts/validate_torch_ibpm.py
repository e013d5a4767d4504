#!/usr/bin/env python
"""Physics validation of the PyTorch/CUDA port's coupled IBPM on one GPU.

    python scripts/validate_torch_ibpm.py [--out DIR]

``examples/ibpm/cylinder2dRe550`` and its pinned-pressure twin
``cylinder2dRe550_GPU`` (450^2 stretched grid, the 314-point body, dt
0.0025, float32; ``chip_smoke.re550_config``) through
``IBPMSolver.run()`` for 1200 steps to t = 3.  Cd(t) against
Koumoutsakos & Leonard (1995) over t in [0.5, 3]: rms <= 0.06 and
largest deviation <= 0.12 (the bracket of
``scripts/validate_forces.py:_case_kl_cylinder``, VALIDATION.md row 5).
Each run then profiles 10 more steps (device busy share, kernels by
device time).

Writes ``torch_cylinder2dRe550_ibpm.json`` and
``torch_cylinder2dRe550_GPU.json`` into ``--out`` (default
``validation/``) and prints them; the exit code is 0 when both are
inside the bracket with every solve converged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import chip_smoke
    from validate_torch_3d import _card, _profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "validation"))
    args = ap.parse_args()
    card = _card()
    ok = True
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, pinned in (("torch_cylinder2dRe550_ibpm.json", False),
                             ("torch_cylinder2dRe550_GPU.json", True)):
            solver, record, _ = chip_smoke.re550_run(
                os.path.join(tmp, name), pinned)
            record.update(package="petibm_tpu_torch",
                          profile=_profile(solver), **card)
            solver.close()
            ok = ok and record["curve_vs_koumoutsakos_leonard_1995"]["pass"]
            line = json.dumps(record)
            print(line)
            with open(os.path.join(args.out, name), "w") as fh:
                fh.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
