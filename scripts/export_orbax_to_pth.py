#!/usr/bin/env python
"""Export a bts_tpu orbax checkpoint to a bts_tpu_torch ``.pth``.

    python scripts/export_orbax_to_pth.py <orbax checkpoint dir> <out.pth>

The directory is one ``bts_tpu`` saved (a full training checkpoint such as
``<log_directory>/<model_name>/model-<step>``, or a params-only one). It is
read with ``bts_tpu.training.checkpoint.load_any_checkpoint``, its trees are
mapped onto the port's names by ``bts_tpu_torch.models.convert.
state_dict_from_flax``, and the result is written as the reference trainer's
dict: ``model``, ``global_step`` and, where the checkpoint tracked them, the
three best-eval entries. The port serves it with ``--checkpoint_path`` and
resumes from it (fresh optimizer moments, the LR schedule at the step); a
TF-flavor run's export carries the decoder's biases, so ``--model_flavor
auto`` builds the TF graph for it.

This script imports both packages (jax and torch); the port itself never
imports jax, which is why it reads no orbax directory on its own.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BEST_KEYS = ("best_eval_measures_lower_better", "best_eval_measures_higher_better",
             "best_eval_steps")


def export(src: str, out: str) -> dict:
    """Write ``src``'s weights and meta to ``out``; returns the payload."""
    import numpy as np
    import torch

    from bts_tpu.training.checkpoint import load_any_checkpoint
    from bts_tpu_torch.models.convert import state_dict_from_flax

    if not os.path.isdir(src):
        raise FileNotFoundError(f"{src} is not an orbax checkpoint directory")
    params, stats, meta = load_any_checkpoint(src, return_meta=True)
    payload = {"global_step": int(meta.get("global_step", 0)),
               "model": state_dict_from_flax(params, stats)}
    best = meta.get("best")
    if best is not None:
        payload.update({k: torch.from_numpy(np.array(best[k])) for k in BEST_KEYS})
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="a bts_tpu orbax checkpoint directory")
    ap.add_argument("out", help="the .pth file to write")
    args = ap.parse_args(argv)
    payload = export(args.checkpoint, args.out)
    tf_graph = "decoder.get_depth.0.bias" in payload["model"]
    print(f"wrote {args.out}: {len(payload['model'])} tensors, global_step "
          f"{payload['global_step']}, {'TF' if tf_graph else 'PT'} graph")
    return 0


if __name__ == "__main__":
    sys.exit(main())
