"""Evaluation table: fill rate / RMSE per scene vs refined-ESL ground truth.

Reproduces the reference's paper-Table-1 generator
(eval/create_evaluation_table.py:84-180) over the same directory layout:
<object_dir>/<seq>/esl/depth_optim_filtered (GT), esl/depth_init,
x_maps/depth_init, mc3d/depth.  Methods that have no outputs present are
skipped rather than aborting.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from xmaps_tpu_torch.utils.eval_metrics import (
    combine_depths,
    evaluation_stats,
    load_and_filter,
)

SCENES = [
    "seq9",  # David
    "seq8",  # Heart
    "seq1",  # Book-Duck
    "seq2",  # Plant
    "seq3",  # City of Lights
    "seq7",  # Cycle
    "seq6",  # Room
    "seq5",  # Desk-chair
    "seq4",  # Desk-books
]


def _round2(v):
    return str(round(v, 2))


def print_table_line(method, results):
    print(f"{method}", end="")
    for res in results:
        print(f" & {_round2(res[0])} & {_round2(res[1])} ", end="")
    print("\\\\")


def evaluate_sequence(seq_dir: str, min_depth: float, max_depth: float):
    gt_files = sorted(glob.glob(os.path.join(seq_dir, "esl/depth_optim_filtered/*.npy")))
    method_dirs = {
        "ESL (init)": sorted(glob.glob(os.path.join(seq_dir, "esl/depth_init/*.npy"))),
        "MC3D": sorted(glob.glob(os.path.join(seq_dir, "mc3d/depth/*.npy"))),
        "X-Maps (ours)": sorted(glob.glob(os.path.join(seq_dir, "x_maps/depth_init/*.npy"))),
    }
    if not gt_files:
        return None

    gt_combined, avg_depth = combine_depths(
        (np.load(f) for f in gt_files), min_depth, max_depth
    )

    results = {}
    for method, files in method_dirs.items():
        if len(files) != len(gt_files):
            continue
        per_frame = []
        for gt_f, est_f in zip(gt_files, files):
            gt = load_and_filter(np.load(gt_f), gt_combined, min_depth, max_depth)
            est = load_and_filter(np.load(est_f), gt_combined, min_depth, max_depth)
            s = evaluation_stats(est, gt)
            per_frame.append([s.fillrate, s.rmse])
        results[method] = np.mean(np.array(per_frame), axis=0)
    return results, avg_depth


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Aggregate fill-rate / RMSE / Middlebury metrics across "
        "evaluated scenes into the paper's Table-1 rows"
    )
    parser.add_argument("-object_dir", type=str, default="")
    parser.add_argument("-max_depth", type=float, default=120)
    parser.add_argument("-min_depth", type=float, default=20)
    parser.add_argument("-scenes", type=str, nargs="*", default=SCENES)
    args = parser.parse_args(argv)

    print(f"Max depth {args.max_depth}")
    all_results: dict[str, list] = {}
    print("Mean depth ", end="")
    for seq in args.scenes:
        out = evaluate_sequence(
            os.path.join(args.object_dir, seq), args.min_depth, args.max_depth
        )
        if out is None:
            continue
        results, avg_depth = out
        print(" & \\multicolumn{{2}}{{c}}{{{}}}".format(round(avg_depth, 1)), end="")
        for method, res in results.items():
            all_results.setdefault(method, []).append(res)
    print("")
    for method, res_list in all_results.items():
        print_table_line(method, res_list)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
