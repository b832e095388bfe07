#!/usr/bin/env python
"""Export a bts_tpu orbax checkpoint to a bts_tpu_torch ``.pth``.

    python scripts/export_orbax_to_pth.py <orbax checkpoint dir> <out.pth>

The directory is one ``bts_tpu`` saved: a full training checkpoint such as
``<log_directory>/<model_name>/model-<step>``, or a params-only one. It is
restored with orbax without a template, and the result is written as the
reference trainer's dict:

* ``model``: the params and batch stats on the port's names
  (``bts_tpu_torch.models.convert.state_dict_from_flax``);
* ``global_step`` and, where the checkpoint tracked them, the three
  best-eval entries;
* ``optimizer``, for a full training checkpoint: optax's state as an
  ``AdamW.state_dict()`` (``bts_tpu_torch.training.optim.
  adamw_state_from_optax``), each group's Adam and schedule counts and every
  ``mu``/``nu`` on the port's names, ``mu`` in its own dtype.

Without a template orbax gives optax's NamedTuples back as dicts and lists
(a masked leaf as None), so the export needs neither the run's config nor
``bts_tpu``'s optimizer: ``adamw_state_from_optax`` walks that raw tree, by
field name where orbax kept one and by position where it did not.

``cli.train --checkpoint_path <out.pth>`` then resumes the run where
``bts_tpu`` would (its moments, counts, step and best tracker). ``cli.test``
serves it; a TF-flavor run's export carries the decoder's biases, so
``--model_flavor auto`` builds the TF graph for it.

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
    """Write ``src``'s weights, optimizer state and meta to ``out``; returns
    the payload."""
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from bts_tpu_torch.models.convert import state_dict_from_flax
    from bts_tpu_torch.training.optim import adamw_state_from_optax

    if not os.path.isdir(src):
        raise FileNotFoundError(f"{src} is not an orbax checkpoint directory")
    with ocp.PyTreeCheckpointer() as ckptr:
        restored = ckptr.restore(os.path.abspath(src))
    payload = {"global_step": int(restored.get("global_step", 0)),
               "model": state_dict_from_flax(restored["params"],
                                             restored.get("batch_stats") or {})}
    if restored.get("opt_state") is not None:
        payload["optimizer"] = adamw_state_from_optax(restored["opt_state"])
    best = restored.get("best")
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
    opt = payload.get("optimizer")
    moments = (f"optimizer moments of {len(opt['state'])} parameters" if opt
               else "no optimizer state")
    print(f"wrote {args.out}: {len(payload['model'])} tensors, global_step "
          f"{payload['global_step']}, {moments}, {'TF' if tf_graph else 'PT'} graph")
    return 0


if __name__ == "__main__":
    sys.exit(main())
