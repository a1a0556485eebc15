"""Padding share of the profiled batches, in %: 1 - sum(real ligand atoms
x real residues) / sum(rows x max_ligand x max_protein), from the batches'
requests (a count that repeats exactly for a seed)."""
from benchmark.metrics import _common as common


def read(ctx):
    bs = common.profiled_batches(ctx)
    padded = sum(b["padded"] for b in bs)
    if not padded:
        return None
    return 100.0 * (1.0 - sum(b["real"] for b in bs) / padded)
