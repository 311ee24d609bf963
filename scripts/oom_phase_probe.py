"""Phase 18 of ``chip_smoke.py`` (a real out-of-memory error of Filter and
its low-memory rerun) under PyTorch caches fragmented on purpose: blocks
of 45 MiB, 3 MiB and 0.375 MiB freed between live tensors, then none.
Needs one CUDA card:

    python3 scripts/oom_phase_probe.py
"""
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nellie_tpu_torch.device import resolve_device  # noqa: E402

MiB = 2 ** 20


def main():
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    resolve_device("cuda")
    cs.build_kernels()
    for name, piece, count in (("45 MiB fragments", 45, 16), ("3 MiB fragments", 3, 240),
                               ("0.375 MiB fragments", 0.375, 1920),
                               ("no fragments", 0, 0)):
        held = []
        if count:
            big = torch.empty(int(piece * count * MiB), dtype=torch.uint8, device="cuda")
            del big
            parts = [torch.empty(int(piece * MiB), dtype=torch.uint8, device="cuda")
                     for _ in range(count)]
            held = parts[1::2]
            del parts
            torch.cuda.empty_cache()
        cached = (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / MiB
        print(f"--- {name}: {cached:.1f} MiB cached but unused before phase 18", flush=True)
        root = tempfile.mkdtemp(prefix="oom_probe_")
        start = time.perf_counter()
        try:
            print(cs.phase_out_of_memory(gpu, root), f"{time.perf_counter() - start:.1f} s",
                  flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            del held
            torch.cuda.empty_cache()
    print("probe done", flush=True)


if __name__ == "__main__":
    main()
