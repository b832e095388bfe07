"""Reference-accuracy reproduction: ``scripts/reproduce_reference.py`` in the port.

    python -m bts_tpu_torch.tools.reproduce_reference --encoder densenet161_bts \\
        --dataset nyu --checkpoint <bts_nyu_v2_pytorch_densenet161/model> \\
        --data_path <nyu/test> --gt_path <nyu/test>

With the datasets and a reference zoo checkpoint on disk it runs the chain
the reference documents (pytorch/README.md:22-31, tensorflow/README.md:60-89):
predict (``apps.predict``, on the card unless ``--device cpu``), then
``evaluation.png_eval`` over the pngs, and checks d1 and AbsRel within
``--tolerance`` (0.002, BASELINE.md's bound) of the published number for the
backbone, dataset and graph. The checkpoint is a ``.pth`` (reference or
port) or a TF checkpoint prefix (the TF zoo's ``bts_nyu_v2`` /
``bts_eigen_v2``; ``--model_flavor auto`` resolves the TF graph and caffe
normalization from it; reading it needs tensorflow). An orbax directory is
refused: export it first with ``scripts/export_orbax_to_pth.py``.

Exit code 0: every checked metric within tolerance; 1: any miss (the report
prints both sides either way).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

# Published zoo numbers (BASELINE.md; the reference READMEs' tables).
# (encoder, dataset, flavor) -> {metric: value}
PUBLISHED = {
    ("resnet50_bts", "kitti", "pt"): {"d1": 0.954, "abs_rel": 0.061},
    ("resnet101_bts", "kitti", "pt"): {"d1": 0.954, "abs_rel": 0.061},
    ("resnext50_bts", "kitti", "pt"): {"d1": 0.954, "abs_rel": 0.061},
    ("resnext101_bts", "kitti", "pt"): {"d1": 0.956, "abs_rel": 0.059},
    ("densenet121_bts", "kitti", "pt"): {"d1": 0.951, "abs_rel": 0.063},
    ("densenet161_bts", "kitti", "pt"): {"d1": 0.955, "abs_rel": 0.060},
    ("resnet50_bts", "nyu", "pt"): {"d1": 0.865, "abs_rel": 0.119},
    ("resnet101_bts", "nyu", "pt"): {"d1": 0.871, "abs_rel": 0.113},
    ("resnext50_bts", "nyu", "pt"): {"d1": 0.867, "abs_rel": 0.116},
    ("resnext101_bts", "nyu", "pt"): {"d1": 0.880, "abs_rel": 0.111},
    ("densenet121_bts", "nyu", "pt"): {"d1": 0.871, "abs_rel": 0.118},
    ("densenet161_bts", "nyu", "pt"): {"d1": 0.885, "abs_rel": 0.110},
    # TF zoo (tensorflow/README.md:89,198).
    ("densenet161_bts", "nyu", "tf"): {"d1": 0.886, "abs_rel": 0.110},
    ("densenet161_bts", "kitti", "tf"): {"d1": 0.952, "abs_rel": 0.063},
}

# eval_with_pngs protocol per dataset (pytorch/README.md:31,102).
PROTOCOL = {
    "nyu": dict(
        min_depth_eval=1e-3, max_depth_eval=10.0, eigen_crop=True,
        max_depth=10.0, input_height=480, input_width=640,
    ),
    "kitti": dict(
        min_depth_eval=1e-3, max_depth_eval=80.0, garg_crop=True,
        do_kb_crop=True, max_depth=80.0, input_height=352, input_width=1216,
    ),
}

METRIC_INDEX = {"silog": 0, "abs_rel": 1, "log10": 2, "rms": 3,
                "sq_rel": 4, "log_rms": 5, "d1": 6, "d2": 7, "d3": 8}

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_metrics(measures, encoder, dataset, flavor, tolerance):
    """Compare the measured 9-vector with the published row. Returns (ok, lines)."""
    key = (encoder, dataset, flavor)
    if key not in PUBLISHED:
        return False, [f"no published number for {key} (MobileNetV2 is TBA "
                       f"in the reference zoo)"]
    ok = True
    lines = []
    for metric, want in PUBLISHED[key].items():
        got = float(measures[METRIC_INDEX[metric]])
        hit = abs(got - want) <= tolerance
        ok &= hit
        lines.append(
            f"{metric:8s} got {got:.4f}  published {want:.4f}  "
            f"|diff| {abs(got - want):.4f}  "
            f"{'OK' if hit else 'MISS (tol %.3f)' % tolerance}"
        )
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--encoder", required=True)
    ap.add_argument("--dataset", required=True, choices=("nyu", "kitti"))
    ap.add_argument("--checkpoint", required=True, help=".pth file or TF checkpoint prefix")
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--filenames_file", default="",
                    help="defaults to the vendored official test split")
    ap.add_argument("--bts_size", type=int, default=512)
    ap.add_argument("--tolerance", type=float, default=0.002)
    ap.add_argument("--eval_batch_size", type=int, default=8)
    ap.add_argument("--keep_predictions", action="store_true")
    ap.add_argument("--device", default="", help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    from bts_tpu_torch.apps.predict import run_predictions
    from bts_tpu_torch.cli.test import resolve_device
    from bts_tpu_torch.config import Config, _check
    from bts_tpu_torch.evaluation.metrics import EVAL_METRICS
    from bts_tpu_torch.evaluation.png_eval import eval_pngs

    split = args.filenames_file or os.path.join(
        ROOT, "train_test_inputs",
        "nyudepthv2_test_files_with_gt.txt" if args.dataset == "nyu"
        else "eigen_test_files_with_gt.txt",
    )
    cfg = _check(Config(
        model_name="reproduce",
        encoder=args.encoder,
        dataset=args.dataset,
        data_path=args.data_path,
        gt_path=args.gt_path,
        filenames_file=split,
        checkpoint_path=args.checkpoint,
        bts_size=args.bts_size,
        eval_batch_size=args.eval_batch_size,
        compute_dtype="float32",  # parity first; rerun bf16 for speed
        **PROTOCOL[args.dataset],
    ))
    flavor = cfg.resolved_flavor
    print(f"resolved flavor: {flavor}; normalization: {cfg.resolved_normalization}")

    out_dir = run_predictions(cfg, resolve_device(args.device))
    print(f"predictions dumped to {out_dir}")

    measures, count = eval_pngs(cfg.replace(pred_path=os.path.join(out_dir, "raw")))
    print(f"{count} samples scored")
    print(", ".join(f"{m}={v:.4f}" for m, v in zip(EVAL_METRICS, measures)))

    ok, lines = check_metrics(measures, args.encoder, args.dataset, flavor, args.tolerance)
    print("\n".join(lines))
    if not args.keep_predictions:
        shutil.rmtree(out_dir, ignore_errors=True)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
