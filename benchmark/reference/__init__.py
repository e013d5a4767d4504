"""The plain references the benchmark holds the port to: plain PyTorch,
importing nothing of the program.

A configuration names its reference as ``"reference": "<module>.<Class>"``
(``ibpm.DecoupledIBPM`` where the key is absent), resolved in this
package by ``harness.resolve_reference``; a new reference is a new
module here.  Every reference class keeps one interface:

- ``Class(config, body, *, device, precision="float64")``: ``config``
  the solver's configuration (``mesh``, ``flow``, ``parameters``, and
  ``bodies`` where the case has any, each file's path resolved);
  ``body`` the points of the configuration's ``body`` file, or None;
  ``precision`` "float64" (the reference) or "tf32" (its control, in
  float32 with every matrix product's operands rounded to TF32);
- ``dim``, and ``lines[c][d].coord``: the coordinates of component c's
  points along direction d, with a ghost at each end (the seed's fields
  are evaluated on them, the pressure's on a component's across d);
- ``initial_state(fields)``: the whole state at step 0 as numpy leaves,
  with the keys and shapes of the port's state for that solver (the
  harness checks them), from the velocity fields and ``p`` where given;
- ``load(host_state)``: a state of numpy leaves (the solver's, or
  ``initial_state``'s) as the tensors the step reads;
- ``advance(state, k)``: k steps; its state holds ``q`` and ``p``, and
  ``f`` where there are bodies.

``ibpm.DecoupledIBPM``: the decoupled IBPM, one stationary body in a
walled box.  ``navierstokes.NavierStokes``: the projection step with no
body, periodic axes and Dirichlet walls.
"""
