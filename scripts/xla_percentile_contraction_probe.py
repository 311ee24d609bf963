"""Which threshold the reference's Filter finalize applies, to the ulp.

    python scripts/xla_percentile_contraction_probe.py [--frames 5] [--seed 0]

The percentile's last step, s[lo] (1 - frac) + s[hi] frac, rounds once in
either of two contracted forms: A = fma(s[lo], 1 - frac, s[hi] frac) and
B = fma(s[hi], frac, s[lo] (1 - frac)); the reference's opening compares
each term with the form its fusion contracts, and so does the port
(``frangi.FINALIZE_FORMS``; ``scripts/xla_finalize_contractions.py`` reads
the forms fusion by fusion).  The script builds 8 x 16 x 16 frames whose strided
sample (every second voxel on each axis, 256 values, ``max_samples`` 256)
is the only positive content but for a 7-voxel cross centred on an odd
voxel, which the sample never reads and which the opening keeps exactly
when all 7 values exceed the threshold.  For samples where A and B differ
it sets the cross to A, to B and to the float after max(A, B), runs the
reference's jitted ``finalize_frame`` and the port's, and prints whether
each kept the cross: a kept cross at value z means z > the threshold.
Runs on the CPU; imports the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPE = (8, 16, 16)
CENTRE = (3, 7, 9)
ARMS = ((0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from nellie_tpu.kernels import frangi as j_frangi
    from nellie_tpu_torch.kernels import frangi
    from nellie_tpu_torch.kernels._fp import fma

    def t(x):
        return torch.tensor(np.float32(x))

    rng = np.random.default_rng(args.seed)
    found = 0
    while found < args.frames:
        sample = rng.uniform(5, 6, (4, 8, 8)).astype(np.float32)
        s = np.sort(sample.reshape(-1))
        pos = np.float32(0.01) * np.float32(s.size - 1)
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        frac = np.float32(pos - np.float32(lo))
        one = np.float32(1) - frac
        a = np.float32(fma(t(s[lo]), t(one), t(s[hi] * frac)))
        b = np.float32(fma(t(s[hi]), t(frac), t(s[lo] * one)))
        if a == b:
            continue
        kept = {}
        for name, z in (("A", a), ("B", b), ("above", np.nextafter(max(a, b), np.inf))):
            frame = np.zeros(SHAPE, np.float32)
            frame[::2, ::2, ::2] = sample
            for d in ARMS:
                frame[tuple(c + o for c, o in zip(CENTRE, d))] = z
            ref = np.asarray(j_frangi.finalize_frame(jnp.asarray(frame), 256))[CENTRE] != 0
            port = frangi.finalize_frame(torch.from_numpy(frame), 256).numpy()[CENTRE] != 0
            kept[name] = (bool(ref), bool(port))
        print(f"A {a!r} {'<' if a < b else '>'} B {b!r}: cross kept (reference, port) at A "
              f"{kept['A']}, at B {kept['B']}, above both {kept['above']}", flush=True)
        found += 1


if __name__ == "__main__":
    main()
