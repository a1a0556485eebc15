"""Device memory against Python's cyclic garbage collector, over the serving
phases of chip_smoke.py (needs a CUDA card).

Runs chip_smoke.main of the checkout TREE through phase 5 (FABind+; the
best-of-N phase is not run) and, at every reset and read of the peak-memory
counter (the start and the end of each phase's peak line), prints the bytes
allocated and the collections since the last report that freed device
memory. Modes:

  plain    no interference (chip_smoke itself collects at each phase's
           start);
  saveall  gc.DEBUG_SAVEALL: cyclic garbage is kept, and each report lists
           it (object types, CUDA tensors). Device memory that appears
           there was held only by reference cycles.

    python3 tools/torch_gc_watch.py TREE MODE     # e.g. . plain

To compare two commits, unpack each (git archive) and run both in one call.
"""
import argparse
import collections
import gc
import os
import sys

import torch

MiB = 2**20


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="checkout whose chip_smoke.py runs")
    ap.add_argument("mode", choices=["plain", "saveall"])
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke

    tag = f"[{os.path.basename(tree)} {args.mode}]"
    reset, read = (torch.cuda.reset_peak_memory_stats,
                   torch.cuda.max_memory_allocated)
    state = {"n": 0, "t0": 0, "freed": []}

    def on_gc(phase, info):
        if phase == "start":
            state["t0"] = torch.cuda.memory_allocated()
        elif state["t0"] > torch.cuda.memory_allocated():
            state["freed"].append((info["generation"], state["t0"]
                                   - torch.cuda.memory_allocated()))

    def report(where):
        freed = state["freed"]
        state["freed"] = []
        print(f"{tag} {where}: allocated "
              f"{torch.cuda.memory_allocated() / MiB:.1f} MiB; collections "
              f"that freed device memory: "
              + (", ".join(f"gen{g} {d / MiB:.1f} MiB" for g, d in freed)
                 or "none"), flush=True)
        if args.mode != "saveall":
            return
        gc.collect()
        kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
        tensors, ptrs = collections.Counter(), set()
        for o in gc.garbage:
            if isinstance(o, torch.Tensor) and o.is_cuda:
                s = o.untyped_storage()
                if s.data_ptr() not in ptrs:
                    ptrs.add(s.data_ptr())
                    tensors[(str(o.dtype), tuple(o.shape))] += s.nbytes()
        print(f"{tag}   cyclic garbage: {len(gc.garbage)} objects, CUDA "
              f"storages {sum(tensors.values()) / MiB:.1f} MiB in "
              f"{len(ptrs)}; types {kinds.most_common(12)}; largest "
              f"tensors {[(k, round(v / MiB, 2)) for k, v in tensors.most_common(6)]}",
              flush=True)
        # the saved garbage is found again by every later collection
        del gc.garbage[:]

    def reset_peak(*a, **k):
        state["n"] += 1
        report(f"phase #{state['n']} starts")
        return reset(*a, **k)

    def read_peak(*a, **k):
        v = read(*a, **k)
        print(f"{tag} phase #{state['n']} peak {v / MiB:.1f} MiB", flush=True)
        report(f"phase #{state['n']} ends")
        return v

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    gc.callbacks.append(on_gc)
    if args.mode == "saveall":
        gc.set_debug(gc.DEBUG_SAVEALL)
    torch.cuda.reset_peak_memory_stats = reset_peak
    torch.cuda.max_memory_allocated = read_peak
    chip_smoke.best_of_phase = stop
    try:
        rc = chip_smoke.main([])
    except Stop:
        rc = 0
    sys.exit(rc)


if __name__ == "__main__":
    main()
