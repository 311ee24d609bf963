"""Time the capacity label product's copy down from the card in two forms,
on the labels of the 1024^3 capacity volume.

    python3 scripts/capacity_label_transfer.py [--edge 1024] [--reps 3]

Needs a CUDA GPU; imports no JAX.  It runs ``segment_volume`` on
``chip_smoke.capacity_volume(edge)`` once on the card, then puts the labels
it returned back on the card in two forms and times each form's way to the
host, in turns: sparse (the foreground's int32 indices and labels copied
down and scattered into a zeroed host array, what the chunked strategy's
``_label_chunked`` does) and dense (the whole labels volume copied down).
Each form's host result is held equal to the run's labels.  The sparse
form's seconds are split into the copy, the zeroed array and the scatter,
and its last two steps are timed again by torch on the CPU (spread over
the cores) beside numpy (the path's own).  It ends with one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edge", type=int, default=1024)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke
    from nellie_tpu_torch.device import resolve_device
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity

    resolve_device("cuda")
    gpu = chip_smoke.gpu_line()
    params = FrangiParams(sigmas=chip_smoke.CAPACITY_SIGMAS, spacing=(1.0, 1.0, 1.0),
                          z_ratio=1.0)
    out = capacity.segment_volume(chip_smoke.capacity_volume(args.edge), params,
                                  emit="sparse_labels", device="cuda")
    labels = out["labels"].reshape(-1)
    n = labels.size
    signed = labels.view(np.int16) if labels.dtype == np.uint16 else labels
    idx = np.flatnonzero(labels).astype(np.int32)
    on_card = {"dense": torch.from_numpy(signed).cuda(),
               "indices": torch.from_numpy(idx).cuda(),
               "values": torch.from_numpy(signed[idx]).cuda()}
    print(f"capacity {args.edge}^3: {out['n_labels']} labels ({labels.dtype}), fg_count "
          f"{out['fg_count']} ({out['fg_count'] / n:.4%}); the chunked label pass "
          f"{out['seconds']['label']:.3f} s, its assembly {out['seconds']['assembly']:.3f} s "
          f"[{gpu}]", flush=True)

    def sparse():
        start = time.perf_counter()
        i = on_card["indices"].cpu().numpy()
        v = on_card["values"].cpu().numpy().view(labels.dtype)
        copied = time.perf_counter()
        host = np.zeros(n, labels.dtype)
        zeroed = time.perf_counter()
        host[i] = v
        done = time.perf_counter()
        return host, {"s": done - start, "copy_s": copied - start, "zeros_s": zeroed - copied,
                      "scatter_s": done - zeroed, "bytes": i.nbytes + v.nbytes}

    def dense():
        start = time.perf_counter()
        host = on_card["dense"].cpu().numpy().view(labels.dtype)
        return host, {"s": time.perf_counter() - start, "bytes": host.nbytes}

    forms = {"sparse": sparse, "dense": dense}
    times = {form: [] for form in forms}
    for rep in range(args.reps):
        for form in (forms if rep % 2 == 0 else reversed(list(forms))):
            torch.cuda.synchronize()
            host, t = forms[form]()
            if not np.array_equal(host, labels):
                sys.exit(f"the {form} form's host labels differ from the run's")
            del host
            times[form].append(t)
            print(f"{form}: " + ", ".join(f"{k} {v:.4f}" if k != "bytes" else f"{v} bytes"
                                          for k, v in t.items()) + f" [{gpu}]", flush=True)
    best = {form: {k: min(t[k] for t in ts) for k in ts[0]} for form, ts in times.items()}
    host_step = {"numpy": [], "torch": []}
    for rep in range(args.reps):
        for how in (host_step if rep % 2 == 0 else reversed(list(host_step))):
            start = time.perf_counter()
            if how == "numpy":
                product = np.zeros(n, labels.dtype)
                product[idx] = labels[idx]
            else:
                product = torch.zeros(n, dtype=on_card["values"].dtype)
                product[torch.from_numpy(idx).long()] = torch.from_numpy(signed[idx])
            host_step[how].append(time.perf_counter() - start)
            del product
    print(f"the sparse form's host step ({idx.size} labels into {n} zeros): numpy "
          f"{min(host_step['numpy']):.4f} s, torch on {torch.get_num_threads()} threads "
          f"{min(host_step['torch']):.4f} s (least of {args.reps})", flush=True)
    print(json.dumps({"gpu": gpu, "edge": args.edge, "fg_count": out["fg_count"],
                      "n_labels": out["n_labels"], "best": best,
                      "host_step_s": {k: min(v) for k, v in host_step.items()}}), flush=True)


if __name__ == "__main__":
    main()
