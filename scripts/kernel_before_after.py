"""Time the port's hand kernels and its segmentation beside an earlier tree's.

    mkdir -p chip_checkout/earlier
    git archive <commit> | tar -x -C chip_checkout/earlier
    python3 scripts/kernel_before_after.py chip_checkout/earlier [--out FILE]

The argument is an unpacked earlier checkout of the repo (the parent
commit, say).  Needs a CUDA GPU; imports no JAX.

First, in this process and with this tree, it runs ``chip_smoke.py``'s 3D
and 2D main paths (phases 4 and 6, with their checks) and the 1024^3
capacity path (phase 11), and keeps the union-find and interpolation
calls that phase 17 times (``chip_smoke.ccl_rows`` and ``interp_rows``).
Then four child processes, in turns (earlier, this, this, earlier), each
importing the package of its own tree:

- each tree's union-find and interpolation kernel on those inputs: a
  digest of each output (the trees must agree, NaN taken as one value),
  its time per call (CUDA events) and on the device (``torch.profiler``);
- each tree's 1-D correlation (``filters.correlate1d_traced`` and
  ``filters._correlate1d``, ``csrc/gauss_axis.cu``) on the 3D and 2D main
  paths' largest cascade calls and the 3D path's largest LoG call, and its
  nearest seed (``edt.nearest_seed``, ``csrc/nearest_seed.cu``) on the 3D
  and 2D paths' largest Network calls, each with its caller's own
  arguments;
- each tree's Frangi tail (``frangi.hessian_frob`` and
  ``frangi.frangi_response``, ``csrc/frangi_tail.cu``) on the 3D, 2D and
  capacity paths' largest calls of each pass, with their callers' own
  arguments (the core as a box);
- each tree's tracker pair sums (``matching.pair_stats``), pair costs
  (``matching.pair_costs``) and ROI statistics
  (``moments.masked_mean_variance``) on the 3D and 2D main paths' largest
  calls, and its histogram thresholds (``thresholds.
  min_triangle_otsu``, ``otsu_threshold``, ``triangle_threshold``) on the
  3D, 2D and capacity paths' largest call of each, with their callers' own
  arguments;
- each tree's 3D thinning (``skeleton.skeletonize_3d``) on the 3D main
  path's largest Network mask, its 2D thinning
  (``skeleton.skeletonize_2d``) on the 2D path's, its distance transform
  (``edt.distance_transform``) on the 3D and 2D paths' largest Markers
  calls, its masked percentile (form A: ``frangi.masked_percentile_forms``,
  or ``masked_percentile`` on a tree without it) on the 3D, 2D and
  capacity paths' largest calls and its log-Hu features
  (``moments.hu_features``, or the composition a tree without it called)
  on the 3D and 2D paths' largest calls, and its fused
  multiply-add (``_fp.fma``) on
  the 3D path's largest ``fma_f32`` call, then ``_fp.log``, ``_fp.exp``,
  ``_fp.sum_of_products`` (three pairs) and ``_fp.reduce_sum_of_squares``
  (three columns) on 4,194,304 seeded values: a digest, the time per call
  and on the device on a cold L2 (``chip_smoke.cold_times``), and the
  multiply-add kernels' launches a call (one a contracted step on a tree
  without the chains);
- the fused segmentation chain (``FusedSegmentation.run(fence_stages=True)``)
  on the 3D main series and on the 2D movie, each once to warm up and once
  timed: its wall, Filter, Network and Markers seconds, and a digest of
  every file it wrote (the script names the files that differ between the
  trees);
- ``run`` on the 3D main series and on the 2D movie: the seconds of each
  stage (tracking's among them) and a digest of every file written, the
  flow vectors and the feature CSVs among them, then the tracking stage
  alone again under ``torch.profiler`` (``chip_smoke.tracking_launches``:
  its CUDA kernels);
- ``capacity.segment_volume`` on ``chip_smoke.capacity_volume(1024)``: its
  wall, its seconds by phase (the cross-cell merge among them: ``merge``
  on the card, or ``host_merge`` and ``assembly`` on a tree that merged on
  the host), its label count and a digest of its labels (dtype and bytes;
  the trees must agree);
- the Filter stage's host reads on the 3D main series
  (``chip_smoke.filter_host_reads``, counted by
  ``torch.cuda.set_sync_debug_mode``).

The last line is one JSON object: each kernel row's times on both trees
(the least of each tree's two turns) and the seconds of every turn.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
TURNS = ("earlier", "this", "this", "earlier")


def load_chip_smoke():
    """This tree's ``chip_smoke`` module, whatever package ``sys.path``
    finds first."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def digest(out):
    if isinstance(out, tuple):
        return "".join(digest(o)[:8] for o in out)
    if out.dtype == torch.bool:
        out = out.to(torch.uint8)
    if out.is_floating_point():
        out = torch.where(torch.isnan(out), torch.full_like(out, float("nan")), out)
    return hashlib.sha256(out.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def child(tree, rows_path, out_path, label):
    """One turn, on ``tree``'s package: the kernel rows, then the fused
    chain and the capacity path."""
    sys.path.insert(0, tree)
    import nellie_tpu_torch

    if os.path.dirname(os.path.dirname(os.path.realpath(nellie_tpu_torch.__file__))) != tree:
        sys.exit(f"imported {nellie_tpu_torch.__file__}, not the package of {tree}")
    chip_smoke = load_chip_smoke()
    from nellie_tpu_torch.device import resolve_device
    from nellie_tpu_torch.kernels import ccl
    from nellie_tpu_torch.kernels.frangi import FrangiParams
    from nellie_tpu_torch.pipeline import capacity
    from nellie_tpu_torch.pipeline.run import run
    from nellie_tpu_torch.stages import flow_interpolation as fi

    resolve_device("cuda")
    gpu = chip_smoke.gpu_line()
    # tensors, strings, numbers, dtypes and the correlations' numpy weights:
    # this process's own file
    rows = torch.load(rows_path, weights_only=False)
    result = {"tree": label, "kernels": {}}
    for row, (fn, args) in kernel_rows(rows).items():
        out = digest(fn(*args))
        launches = fma_launches()
        fn(*args)
        launches = fma_launches() - launches
        reps = 5 if row == "thin26" or row.startswith(SLOW_ON_EARLIER) else \
            10 if row.startswith("nearest_seed") else 20
        ms, on_device = chip_smoke.cold_times(lambda: fn(*args), reps)
        result["kernels"][row] = {"ms": ms, "device_ms": on_device, "digest": out,
                                  "fma_launches": launches}
        print(f"{label} tree: {row}: {ms:.4f} ms a call on a cold L2, on the device "
              f"{chip_smoke.fmt_ms(on_device)}, {launches} multiply-add launches a call "
              f"[{gpu}]", flush=True)
    for kind, kernel, reps in (("ccl", ccl.CCL_KERNEL, 20),
                               ("interp", fi.FLOW_INTERP_KERNEL, 10)):
        for row, args in rows[kind].items():
            args = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)
            out = digest(kernel(*args))
            ms, on_device = chip_smoke.kernel_times(lambda: kernel(*args), reps)
            result["kernels"][f"{kind} {row}"] = {"ms": ms, "device_ms": on_device,
                                                  "digest": out}
            print(f"{label} tree: {kind} {row}: {ms:.4f} ms a call, on the device "
                  f"{chip_smoke.fmt_ms(on_device)} [{gpu}]", flush=True)
    result["filter_host_reads"] = chip_smoke.filter_host_reads()
    print(f"{label} tree: the Filter's host reads on the 3D main series "
          f"{result['filter_host_reads']} [{gpu}]", flush=True)
    root = tempfile.mkdtemp(prefix="before_after_")
    try:
        for name in ("warm-up", "timed"):
            wall, stages = chip_smoke.fused_segmentation_seconds(
                root, name, chip_smoke.MAIN_SHAPE, fence=True)
        result.update(seg_fused=wall, filter=stages["filter"], network=stages["network"],
                      markers=stages["markers"],
                      artifacts=artifact_digests(os.path.join(root, "timed")))
        for name in ("warm-up 2D", "timed 2D"):
            wall, stages = chip_smoke.fused_segmentation_seconds(
                root, name, chip_smoke.MAIN_SHAPE_2D, fence=True)
        result.update(seg_fused_2d=wall, filter_2d=stages["filter"],
                      network_2d=stages["network"], markers_2d=stages["markers"])
        result["artifacts"].update({f"2D/{name}": d for name, d in
                                    artifact_digests(os.path.join(root, "timed 2D")).items()})
        for tag, shape in (("3D", chip_smoke.MAIN_SHAPE), ("2D", chip_smoke.MAIN_SHAPE_2D)):
            directory = os.path.join(root, f"whole{tag}")
            im_info, timings = run(chip_smoke.write_series(directory, shape), device="cuda",
                                   return_timings=True)
            result[f"run {tag}"] = dict(timings)
            result[f"tracking launches {tag}"] = chip_smoke.tracking_launches(
                im_info, os.path.join(root, f"flow_profiled{tag}.npy"))
            result["artifacts"].update({f"run {tag}/{name}": d for name, d in
                                        artifact_digests(directory).items()})
            print(f"{label} tree: run on the {tag} main path: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()) + f" [{gpu}]",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    vol = chip_smoke.capacity_volume(chip_smoke.CAPACITY_EDGE)
    params = FrangiParams(sigmas=chip_smoke.CAPACITY_SIGMAS, spacing=(1.0, 1.0, 1.0),
                          z_ratio=1.0)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = capacity.segment_volume(vol, params, emit="sparse_labels", device="cuda")
    result.update(capacity=time.perf_counter() - start,
                  vesselness=out["seconds"]["vesselness"],
                  thresholds=out["seconds"]["thresholds"], n_labels=out["n_labels"],
                  capacity_phases=out["seconds"],
                  labels_digest=hashlib.sha256(out["labels"].dtype.str.encode()
                                               + out["labels"].tobytes()).hexdigest()[:16])
    print(f"{label} tree: seg_fused {result['seg_fused']:.3f} s, filter {result['filter']:.3f} "
          f"s; capacity 1024^3 {result['capacity']:.3f} s, vesselness "
          f"{result['vesselness']:.3f} s, thresholds {result['thresholds']:.3f} s, "
          f"{result['n_labels']} labels (digest {result['labels_digest']}); by phase "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items()) + f" [{gpu}]",
          flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f)


def artifact_digests(directory):
    """{file: digest} of every file the fused chain wrote under
    ``directory`` (its artifacts, the Markers' among them)."""
    out = {}
    for base, _, files in os.walk(directory):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = hashlib.sha256(f.read()).hexdigest()[:16]
    return out


def fma_launches():
    """The multiply-add kernels' launches so far: ``fma_f32``'s single
    calls and, on a tree that has them, its chains."""
    from nellie_tpu_torch.kernels import _fp

    chain = getattr(_fp, "FMA_CHAIN_KERNEL", None)
    return _fp.FMA_KERNEL.launches + (chain.launches if chain is not None else 0)


class CoreBox:
    """A block's core box, [lo, hi) per axis, called as the tail wrappers'
    ``core`` (the caller's closure does not pickle)."""

    def __init__(self, block, core):
        from nellie_tpu_torch.kernels import frangi

        self.lo, self.hi = frangi._core_box(block, core(block))

    def __call__(self, v):
        for axis, (lo, hi) in enumerate(zip(self.lo, self.hi)):
            v = v.narrow(axis, lo, hi - lo)
        return v


def tail_call(name):
    """``frangi.<name>`` of this process's package, its tensors only (pass 2
    updates vessel and all_mask in place, the same on every call)."""
    from nellie_tpu_torch.kernels import frangi

    fn = getattr(frangi, name)
    return lambda *args: tuple(t for t in fn(*args) if t is not None)


# the rows whose earlier version is plain torch of many launches a call
SLOW_ON_EARLIER = ("pair_stats", "pair_costs", "masked_mean_variance", "min_triangle_otsu",
                   "otsu_threshold", "triangle_threshold", "triangle_and_otsu",
                   "skeletonize_2d", "distance_transform", "masked_percentile", "hu_features")


def pair_sums(*args):
    """``matching.pair_stats`` of this process's package, its count as a
    tensor."""
    from nellie_tpu_torch.kernels import matching

    count, sums, sumsqs = matching.pair_stats(*args)
    return torch.tensor(count), sums, sumsqs


def pair_costs(*args):
    """``matching.pair_costs`` of this process's package on a tile on the
    card, with ``mean`` and ``std`` on the host where its kernel takes
    them there and on the card for a tree whose plain torch divides by
    them."""
    from nellie_tpu_torch.kernels import matching

    if not hasattr(matching, "PAIR_COSTS_KERNEL"):
        args = args[:5] + tuple(a.cuda() for a in args[5:7]) + args[7:]
    return matching.pair_costs(*args)


def threshold_call(name):
    """``thresholds.<name>`` of this process's package; for a tree without
    ``triangle_and_otsu``, the two calls its Label made in its place."""
    from nellie_tpu_torch.kernels import thresholds

    if name == "triangle_and_otsu" and not hasattr(thresholds, name):
        return lambda v, m, n: (thresholds.triangle_threshold(v, m, n),
                                thresholds.otsu_threshold(v, m, n)[0])
    return getattr(thresholds, name)


def percentile_a():
    """The percentile's form A (the only form of a tree without
    ``masked_percentile_forms``) from this process's package."""
    from nellie_tpu_torch.kernels import frangi

    forms = getattr(frangi, "masked_percentile_forms", None)
    if forms is None:
        return frangi.masked_percentile
    return lambda *args: forms(*args)[0]


def hu_call():
    """``moments.hu_features`` of this process's package, or, on a tree
    without it, the composition the tracker called in its place."""
    from nellie_tpu_torch.kernels import moments

    if hasattr(moments, "hu_features"):
        return moments.hu_features
    return lambda cubes, looped: moments.log_hu(
        moments.hu_3d(cubes, looped) if cubes.dim() == 4 else moments.hu_2d(cubes, looped))


def kernel_rows(rows):
    """{row: (function, arguments on the card)} of the correlation, nearest
    seed, Frangi tail, pair sums, ROI statistics, threshold, thinning and
    multiply-add rows, on this process's package."""
    import numpy as np

    from nellie_tpu_torch.kernels import _fp, edt, filters, frangi, moments, skeleton

    def cuda(args):
        return tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args)

    rng = np.random.default_rng(13)
    a, b, c = (torch.from_numpy(rng.standard_normal(1 << 22).astype(np.float32)).cuda()
               for _ in range(3))
    positive = a.abs() + 1e-3
    return {**{f"gauss_axis {path}": (getattr(filters, which), cuda(args))
               for path, (which, args) in rows["gauss"].items()},
            **{f"nearest_seed {path}": (edt.nearest_seed, cuda(args))
               for path, args in rows["seed"].items()},
            **{f"frangi_tail {row}": (tail_call(name), cuda(args))
               for row, (name, args) in rows["tail"].items()},
            **{f"pair_stats {path}": (pair_sums, cuda(args))
               for path, args in rows["pair_stats"].items()},
            **{f"pair_costs {path}": (pair_costs, cuda(args[:4]) + tuple(args[4:]))
               for path, args in rows["pair_costs"].items()},
            **{f"masked_mean_variance {path}": (moments.masked_mean_variance, cuda(args))
               for path, args in rows["roi"].items()},
            **{row: (threshold_call(row.split()[0]), cuda(args))
               for row, args in rows["thresholds"].items()},
            "thin26": (skeleton.skeletonize_3d, cuda(rows["thin26"])),
            "skeletonize_2d 2D": (skeleton.skeletonize_2d, cuda(rows["thin2d"])),
            **{f"distance_transform {path}": (edt.distance_transform, cuda(args))
               for path, args in rows["edt"].items()},
            **{f"masked_percentile {path}": (percentile_a(), cuda(args))
               for path, args in rows["percentile"].items()},
            **{f"hu_features {path}": (hu_call(), cuda(args))
               for path, args in rows["hu"].items()},
            "fma_f32 3D largest": (_fp.fma, cuda(rows["fma"])),
            "log": (_fp.log, (positive,)),
            "exp": (_fp.exp, (a * 4,)),
            "sum_of_products": (lambda x, y, z: _fp.sum_of_products([(x, y), (y, z), (z, x)]),
                                (a, b, c)),
            "reduce_sum_of_squares": (_fp.reduce_sum_of_squares,
                                      (torch.stack([a, b, c], dim=-1),))}


def record(rows_path):
    """The kernel rows from this tree's main paths and capacity path,
    saved on the host to ``rows_path``."""
    chip_smoke = load_chip_smoke()
    from nellie_tpu_torch.device import resolve_device
    from nellie_tpu_torch.kernels import nn

    resolve_device("cuda")
    gpu = chip_smoke.gpu_line()
    root = tempfile.mkdtemp(prefix="before_after_")
    try:
        hand = chip_smoke.phase_main_path(nn, gpu, root)[4]
        hand_2d = chip_smoke.phase_main_path(nn, gpu, root, chip_smoke.MAIN_SHAPE_2D,
                                             tag="2D ")[4]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    capacity = chip_smoke.phase_capacity_1024(gpu)
    ccl_rows = chip_smoke.ccl_rows({"3D": hand["calls"]["ccl_union_find"],
                                    "2D": hand_2d["calls"]["ccl_union_find"]},
                                   capacity["calls"])
    interp_rows = chip_smoke.interp_rows({"3D": hand["calls"]["flow_interp"],
                                          "2D": hand_2d["calls"]["flow_interp"]})
    host = {kind: {row: tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
                   for row, args in rows.items()}
            for kind, rows in (("ccl", ccl_rows), ("interp", interp_rows))}
    host["thin26"] = hand["largest"]["skeletonize_3d"][1]  # (mask, table) on the host
    host["thin2d"] = hand_2d["largest"]["skeletonize_2d"][1]
    host["edt"] = {"3D": hand["largest"]["distance_transform"][1],
                   "2D": hand_2d["largest"]["distance_transform"][1]}
    host["hu"] = {"3D": hand["largest"]["hu_features"][1],
                  "2D": hand_2d["largest"]["hu_features"][1]}
    host["percentile"] = {path: largest["masked_percentile_forms"][1]
                          for path, largest in (("3D", hand["largest"]),
                                                ("2D", hand_2d["largest"]),
                                                ("capacity", capacity["largest"]))}
    host["gauss"] = {"3D": ("correlate1d_traced", hand["largest"]["correlate1d_traced"][1]),
                     "2D": ("correlate1d_traced", hand_2d["largest"]["correlate1d_traced"][1]),
                     "3D LoG": ("_correlate1d", hand["largest"]["_correlate1d"][1])}
    host["seed"] = {"3D": hand["largest"]["nearest_seed"][1],
                    "2D": hand_2d["largest"]["nearest_seed"][1]}
    host["tail"] = {}
    for path, largest in (("3D", hand["largest"]), ("2D", hand_2d["largest"]),
                          ("capacity", capacity["largest"])):
        for name in ("hessian_frob", "frangi_response"):
            block, *args = largest[name][1]
            if name == "hessian_frob":
                args[2] = CoreBox(block, args[2])
            host["tail"][f"{name} {path}"] = (name, (block, *args))
    host["fma"] = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                        for a in hand["fma_largest"][1])
    host["pair_stats"] = {"3D": hand["largest"]["pair_stats"][1],
                          "2D": hand_2d["largest"]["pair_stats"][1]}
    host["pair_costs"] = {"3D": hand["largest"]["pair_costs"][1],
                          "2D": hand_2d["largest"]["pair_costs"][1]}
    host["roi"] = {"3D": hand["largest"]["masked_mean_variance"][1],
                   "2D": hand_2d["largest"]["masked_mean_variance"][1]}
    host["thresholds"] = {
        f"{name} {path}": largest[name][1]
        for path, largest in (("3D", hand["largest"]), ("2D", hand_2d["largest"]),
                              ("capacity", capacity["largest"]))
        for name in chip_smoke.THRESHOLD_FUNCTIONS if largest[name][1] is not None}
    torch.save(host, rows_path)
    return gpu


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("earlier", help="an unpacked earlier checkout of the repo")
    parser.add_argument("--out", help="also write the last line's JSON here")
    parser.add_argument("--child", nargs=3, metavar=("ROWS", "OUT", "LABEL"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    earlier = os.path.realpath(args.earlier)
    if args.child:
        child(earlier, *args.child)
        return
    sys.path.insert(0, REPO)
    if not os.path.isfile(os.path.join(earlier, "nellie_tpu_torch", "__init__.py")):
        sys.exit(f"{earlier} holds no nellie_tpu_torch package")
    work = tempfile.mkdtemp(prefix="before_after_")
    try:
        rows_path = os.path.join(work, "rows.pt")
        gpu = record(rows_path)
        gc.collect()
        torch.cuda.empty_cache()  # the children need the card's memory
        turns = []
        for k, label in enumerate(TURNS):
            out = os.path.join(work, f"turn{k}.json")
            tree = earlier if label == "earlier" else REPO
            subprocess.run([sys.executable, os.path.abspath(__file__), tree, "--child",
                            rows_path, out, label], check=True, cwd=REPO)
            with open(out) as f:
                turns.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = {}
    for row in turns[0]["kernels"]:
        digests = {t["kernels"][row]["digest"] for t in turns}
        if len({t["kernels"][row]["digest"] for t in turns if t["tree"] == "this"}) != 1:
            sys.exit(f"this tree's turns differ at {row}")
        if len(digests) != 1:
            sys.exit(f"the two trees' kernels differ at {row}")
        kernels[row] = {}
        for label in ("this", "earlier"):
            mine = [t["kernels"][row] for t in turns if t["tree"] == label]
            kernels[row][label] = {
                "ms": min(m["ms"] for m in mine),
                "device_ms": min((m["device_ms"] for m in mine if m["device_ms"] is not None),
                                 default=None)}
            if "fma_launches" in mine[0]:
                kernels[row][label]["fma_launches"] = mine[0]["fma_launches"]
        this, before = kernels[row]["this"], kernels[row]["earlier"]
        print(f"{row}: this tree {this['ms']:.4f} ms a call (on the device "
              f"{fmt(this['device_ms'])}), earlier tree {before['ms']:.4f} ms "
              f"(on the device {fmt(before['device_ms'])}) [{gpu}]", flush=True)
    if len({t["n_labels"] for t in turns}) != 1:
        sys.exit("the two trees' capacity runs found different label counts")
    if len({t["labels_digest"] for t in turns}) != 1:
        sys.exit("the two trees' capacity runs gave different labels")
    print(f"capacity 1024^3 labels byte-equal on both trees (digest "
          f"{turns[0]['labels_digest']}, {turns[0]['n_labels']} labels)", flush=True)
    differ = sorted(name for name in turns[0]["artifacts"]
                    if len({t["artifacts"].get(name) for t in turns}) != 1)
    print(f"the fused chain's files on the 3D and 2D main series and run's on both: "
          f"{len(turns[0]['artifacts'])}, "
          f"differing between the trees: {differ or 'none'}", flush=True)
    seconds = [{k: t[k] for k in ("tree", "seg_fused", "filter", "network", "markers",
                                  "seg_fused_2d", "filter_2d", "network_2d", "markers_2d",
                                  "capacity", "vesselness", "thresholds", "run 3D", "run 2D",
                                  "tracking launches 3D", "tracking launches 2D",
                                  "filter_host_reads", "capacity_phases")}
               for t in turns]
    print("seconds by turn: " + "; ".join(
        f"{s['tree']}: seg_fused {s['seg_fused']:.3f}, filter {s['filter']:.3f}, network "
        f"{s['network']:.3f}, markers {s['markers']:.3f}, 2D seg_fused "
        f"{s['seg_fused_2d']:.3f}, filter {s['filter_2d']:.3f}, network "
        f"{s['network_2d']:.3f}, markers {s['markers_2d']:.3f}, tracking 3D "
        f"{s['run 3D']['tracking']:.3f} ({s['tracking launches 3D']['cuda_kernels']} CUDA "
        f"kernels alone), tracking 2D {s['run 2D']['tracking']:.3f} "
        f"({s['tracking launches 2D']['cuda_kernels']} CUDA kernels alone), capacity "
        f"{s['capacity']:.3f} ("
        + ", ".join(f"{k} {v:.3f}" for k, v in s["capacity_phases"].items())
        + f"), Filter host reads {s['filter_host_reads']}" for s in seconds)
        + f" [{gpu}]", flush=True)
    line = json.dumps({"gpu": gpu, "kernels": kernels, "turns": seconds,
                       "differing_files": differ})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


if __name__ == "__main__":
    main()
