"""The benchmark's plain reference: what decides `correct`.

A frozen copy of the port's plain modules as of the benchmark's first
version (config, sample building and collation, routing, the FABind and
FABind+ models), with the edge gate and dropout as their
plain PyTorch versions (ops/edge_gate.py, ops/dropout.py). It imports
neither JAX nor anything of the port, and is run in float32 with TF32 off:
`dock.py` works out again every pose the timed path served from the same
raw requests and weights.
"""
